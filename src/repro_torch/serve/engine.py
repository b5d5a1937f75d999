"""Request-centric continuous-batching engine over the hybrid KV pool.

The port of ``repro.serve.engine`` for the single-device, dense, greedy
path.  A request runs like this:

* ``submit`` queues it; the configured :class:`~.scheduler.Scheduler`
  orders the waiting requests;
* every ``step()`` admits prompts up to the per-step prefill token budget,
  chunked at KV-block granularity, bucketed into power-of-two padded
  lengths, with ONE prefill dispatch per bucket (the full-recompute
  forward; chunks k > 0 re-forward their prefix);
* every steady decode step (i) maps the block each live sequence is about
  to write, (ii) uploads the dirty TAR/SF/flex entries to the device
  tables in place, (iii) runs the serve step — one RSW launch translates
  every block, each layer runs the paged-attention kernel — (iv) feeds the
  translation telemetry back to the manager (SRRIP hits, flexible-walk
  cost tracking, promotions) globally and per request, and (v) applies
  pending slot migrations as one batched gather/scatter per pool;
* a request ends at ``max_new_tokens`` ("length") or ``eos_token``
  ("stop"); with ``auto_release=True`` its slot and blocks free at once.

Host contract: a step performs ONE device-to-host copy.  The greedy next
tokens, the post-step context lengths, the translation telemetry and the
first tokens of every prefill that completed this step are packed into one
int32 tensor and copied with a single ``.cpu()``.

Features of the JAX engine that are not ported yet keep their
``EngineConfig`` fields, accept only the value that turns them off and
raise ``NotImplementedError`` naming the ROADMAP item otherwise.
Overload follows the fail-fast policy: admission waits until a request's
whole footprint fits, and a decode-time allocation miss raises
``PoolExhausted``.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import HybridConfig, HybridKVManager, PoolExhausted, SWAP
from repro_torch.models import FwdOptions, model_dims
from .decode import DecodeSpec, init_decode_state, make_serve_step
from .prefill import make_prefill_step
from .sampling import GREEDY, SamplingParams, require_greedy
from .scheduler import Scheduler, make_scheduler


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> a fresh tensor on ``device``, without a stream sync
    (an asynchronous copy from pageable memory stages the bytes before it
    returns, so the array may change afterwards)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cpu":
        return t.clone()
    return t.to(device, non_blocking=True)


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


# ------------------------------------------------------------- request API

@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine construction options (the JAX engine's fields).

    ``scheduler`` is a policy name (``"fifo"`` / ``"spf"`` /
    ``"priority"``), a ready Scheduler instance, or a zero-arg factory.
    ``prefill_budget`` is NEW prompt tokens admitted per step (None =
    ``4 * block_size * max_batch``).  ``attn_impl`` picks the prefill's
    causal attention: ``"flash"`` (the flash kernel on the card, its plain
    version on the CPU) or ``"dense"`` (always the plain version).
    ``dtype`` is the activation and KV-pool dtype.

    Not ported yet, off-values only: ``prefill_mode="recompute"``
    (prefix-KV: P9), ``prefix_gather="exact"`` (P9), ``spec_decode=None``
    (P11), ``prefix_cache=None`` (P12), ``overload_policy="fail"`` and
    ``fault_injector=None`` (P13), ``metrics=None`` (P14),
    ``mesh_shape=None`` (P15).
    """
    max_batch: int = 4
    max_seq_len: int = 256
    pool_headroom: float = 1.25
    mode: str = "hybrid"
    attn_impl: str = "flash"
    dtype: Any = torch.float32
    restseg_fraction: float = 0.75
    track_stats: bool = True
    prefill_budget: Optional[int] = None
    auto_release: bool = False
    scheduler: Any = "fifo"
    prefill_mode: str = "recompute"
    prefix_gather: str = "exact"
    spec_decode: Any = None
    num_draft_tokens: int = 4
    spec_ngram: int = 2
    overload_policy: str = "fail"
    fault_injector: Any = None
    mesh_shape: Optional[Tuple[int, int]] = None
    prefix_cache: Any = None
    metrics: Any = None

    def check_ported(self) -> None:
        """Raise for a field set to a feature this slice has not ported."""
        if self.prefill_mode != "recompute":
            raise _not_ported(f"prefill_mode={self.prefill_mode!r} "
                              "(prefix-KV chunked prefill)", "P9")
        if self.prefix_gather != "exact":
            raise _not_ported(f"prefix_gather={self.prefix_gather!r}", "P9")
        if self.spec_decode not in (None, False):
            raise _not_ported("speculative decoding", "P11")
        if self.prefix_cache not in (None, False):
            raise _not_ported("the prefix cache", "P12")
        if self.overload_policy != "fail":
            raise _not_ported(f"overload_policy={self.overload_policy!r} "
                              "(preemption to the host tier)", "P13")
        if self.fault_injector is not None:
            raise _not_ported("the serve fault injector", "P13")
        if self.metrics is not None:
            raise _not_ported("the metrics logger", "P14")
        if self.mesh_shape is not None:
            raise _not_ported("sharded serving (mesh_shape)", "P15")
        if self.attn_impl not in ("flash", "dense"):
            raise ValueError(f"unknown attn_impl {self.attn_impl!r} "
                             "(expected 'flash' or 'dense')")


class ChunkRecord(NamedTuple):
    """One admitted prompt chunk in ``Engine.admission_log``.

    ``fwd_tokens`` is the number of tokens fed through the chunk forward
    (``end``: the recompute path re-forwards the whole prefix)."""
    seq_id: int
    start: int
    end: int
    path: str          # "recompute" ("prefix_kv": ROADMAP P9)
    fwd_tokens: int


@dataclasses.dataclass(frozen=True, eq=False)
class Request:
    """Immutable request submission.  The prompt array is copied and
    marked read-only; runtime state lives in the engine's
    ``RequestState`` and surfaces through ``RequestOutput`` snapshots."""
    seq_id: int
    prompt: np.ndarray
    frontend: Optional[np.ndarray] = None
    max_new_tokens: int = 16
    eos_token: Optional[int] = None
    sampling: SamplingParams = GREEDY
    priority: int = 0
    deadline_ms: Optional[float] = None

    def __post_init__(self):
        p = np.array(self.prompt, copy=True)
        p.setflags(write=False)
        object.__setattr__(self, "prompt", p)

    @property
    def generated(self) -> List[int]:
        st = getattr(self, "_engine_state", None)
        return st.generated if st is not None else []

    @property
    def done(self) -> bool:
        st = getattr(self, "_engine_state", None)
        return st.done if st is not None else False


@dataclasses.dataclass
class RequestState:
    """Engine-internal mutable per-request state."""
    request: Request
    arrival: int                     # engine step at submission (aging)
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: Optional[str] = None   # "stop" | "length"
    new_tokens: List[int] = dataclasses.field(default_factory=list)
    finish_reported: bool = False
    # per-request translation telemetry (stats()["per_request"])
    rsw_hits: int = 0
    flex_walks: int = 0
    swap_faults: int = 0


@dataclasses.dataclass(frozen=True)
class RequestOutput:
    """Streaming snapshot for one request, drained by ``Engine.poll()``."""
    seq_id: int
    new_token_ids: Tuple[int, ...]
    token_ids: Tuple[int, ...]
    finished: bool
    finish_reason: Optional[str]


# ------------------------------------------------------------------ engine

class Engine:
    """Continuous-batching engine on ``device`` (default ``"cuda"``).

    ``params`` must already live on ``device`` (``params.init_params`` or
    ``params.params_from_numpy``)."""

    def __init__(self, cfg: ArchConfig, params,
                 config: Optional[EngineConfig] = None, device="cuda"):
        config = config if config is not None else EngineConfig()
        config.check_ported()
        if cfg.family != "dense":
            raise _not_ported(f"family {cfg.family!r}", "P10")
        self.config = config
        self.cfg = cfg
        self.device = torch.device(device)
        self.dims = model_dims(cfg, tp=1)
        self.params = params
        bs = cfg.kv_block_size
        max_batch, max_seq_len = config.max_batch, config.max_seq_len
        max_blocks = max_seq_len // bs
        self.hybrid_cfg = HybridConfig(
            block_size=bs,
            total_slots=max(16, int(max_batch * max_blocks
                                    * config.pool_headroom) // 8 * 8),
            restseg_fraction=config.restseg_fraction, assoc=8,
            max_seqs=max_batch, max_blocks_per_seq=max_blocks,
            mode=config.mode)
        self.track_stats = config.track_stats
        self.manager = HybridKVManager(self.hybrid_cfg)
        self.spec = DecodeSpec(
            block_size=bs, max_blocks_per_seq=max_blocks,
            slots_per_group=self.hybrid_cfg.total_slots,
            n_sets=self.hybrid_cfg.num_sets, assoc=self.hybrid_cfg.assoc,
            mode="batch", hash_name=self.hybrid_cfg.hash_name)
        dtype = config.dtype
        self.dstate = init_decode_state(cfg, self.dims, self.spec, max_batch,
                                        1, dtype=dtype, device=self.device)
        self.max_batch = max_batch
        self.prefill_budget = (config.prefill_budget
                               if config.prefill_budget is not None
                               else 4 * bs * max_batch)
        if self.prefill_budget < bs:
            raise ValueError(
                f"prefill_budget {self.prefill_budget} is smaller than "
                f"the KV block size {bs}: no prompt chunk could ever be "
                "admitted")
        self.auto_release = config.auto_release
        self.scheduler: Scheduler = make_scheduler(config.scheduler)
        # a scheduler instance is mutable state: sharing one between two
        # engines would let one engine admit the other's requests
        if getattr(self.scheduler, "_bound_engine", None) is not None:
            raise ValueError(
                "scheduler instance is already bound to another Engine; "
                "pass a policy name or factory in EngineConfig instead")
        try:
            self.scheduler._bound_engine = self
        except AttributeError:
            pass                       # slotted/frozen scheduler: skip
        self.fwd = FwdOptions(attn_impl=config.attn_impl, dtype=dtype,
                              collect_cache=True)
        self._serve_step = make_serve_step(cfg, self.dims, self.spec,
                                           dtype=dtype)
        self._prefill_step = make_prefill_step(cfg, self.dims, self.spec,
                                               fwd=self.fwd)
        self.requests: Dict[int, Request] = {}      # registered, live
        self.finished: Dict[int, Request] = {}
        self._states: Dict[int, RequestState] = {}
        self._current: Optional[Request] = None     # mid-chunk prefill
        self._slot_of: Dict[int, int] = {}
        self._prefilling: Dict[int, int] = {}   # seq_id -> tokens installed
        self._step_count = 0                    # scheduler clock (aging)
        self.admission_log: List[ChunkRecord] = []
        # host mirror of ctx_len: block-boundary checks never read the
        # device tensor
        self._ctx_host = np.zeros(max_batch, np.int64)
        self._synced_full = False

    # ------------------------------------------------------------ admission
    @property
    def waiting(self) -> Tuple[Request, ...]:
        """Requests whose prompt is not fully installed yet: the
        engine-owned mid-chunk request (if any) first, then the
        scheduler's queue."""
        head = (self._current,) if self._current is not None else ()
        return head + tuple(self.scheduler.pending())

    def has_unfinished(self) -> bool:
        return bool(self.waiting) or any(
            not self._states[sid].done for sid in self.requests)

    def submit(self, req: Request) -> None:
        """Enqueue a request; ``step()`` admits it under the token budget
        in the order the configured scheduler decides.  A ``seq_id`` may
        be reused once its previous request finished and was released."""
        bs = self.cfg.kv_block_size
        S = len(np.asarray(req.prompt))
        if S == 0:
            raise ValueError("empty prompt: an unadmittable request would "
                             "stall the queue head forever")
        if S % bs:
            raise ValueError(f"prompt length {S} must be a multiple of the "
                             f"KV block size {bs} (pad upstream)")
        require_greedy(req.sampling)
        if req.frontend is not None:
            raise _not_ported("frontend (vlm/audio) inputs", "P10")
        if req.deadline_ms is not None:
            raise _not_ported("request deadlines", "P14")
        old = self._states.get(req.seq_id)
        if old is not None and not old.done:
            raise ValueError(f"seq_id {req.seq_id} is already queued or "
                             "live")
        if req.seq_id in self._slot_of:
            raise ValueError(
                f"seq_id {req.seq_id} finished but still holds its "
                f"sequence slot; call release({req.seq_id}) first or "
                "construct the engine with auto_release=True")
        self.finished.pop(req.seq_id, None)
        state = RequestState(request=req, arrival=self._step_count)
        object.__setattr__(req, "_engine_state", state)
        self._states[req.seq_id] = state
        self.scheduler.add(req, state.arrival)

    def _admit(self, budget: Optional[int]
               ) -> List[Tuple[Request, torch.Tensor]]:
        """Admit waiting prompts up to ``budget`` NEW tokens (None =
        unbounded), in scheduler order, chunked at KV-block granularity.

        Returns [(request, first-token tensor (1,))] for every request
        whose FINAL chunk was installed this call; the caller folds them
        into its single device-to-host copy.
        """
        if self._current is None and not len(self.scheduler):
            return []
        m = self.manager
        bs = self.cfg.kv_block_size
        if budget is None:
            budget = sum(len(np.asarray(r.prompt)) for r in self.waiting)
        chunks: List[Tuple[Request, int, int, bool]] = []
        # exact capacity gating: every accepted chunk's unmapped covering
        # blocks are reserved against a dry-run ledger BEFORE the chunk is
        # committed, so the bucket allocations below never exhaust the pool
        reserved: List[int] = []
        gate_alloc = self.hybrid_cfg.mode != "restrictive_only"
        while budget >= bs:
            req = self._current
            if req is None:
                req = self.scheduler.select(self._step_count)
                if req is None:
                    break
            if req.seq_id not in self._slot_of:
                if not m._free_seq_slots:
                    break                      # wait for a release
                if gate_alloc and not self._footprint_admit(req):
                    break          # fail-fast: serve only what fits whole
                slot = m.register_sequence(req.seq_id)
                self._slot_of[req.seq_id] = slot
                self.requests[req.seq_id] = req
                self._prefilling[req.seq_id] = 0
            start = self._prefilling[req.seq_id]
            total = len(np.asarray(req.prompt))
            take = min(total - start, budget // bs * bs)
            if take <= 0:
                break
            end = start + take
            if gate_alloc:
                need = self._chunk_vpns(req, start, end)
                if need and not self._capacity_ok(reserved, need):
                    if (not reserved
                            and not self._others_hold_blocks(req.seq_id)):
                        raise PoolExhausted(
                            f"request {req.seq_id}'s prompt alone "
                            "exceeds the KV pool and cannot be admitted",
                            **self._pool_diag())
                    break              # defer: stay queued / mid-prefill
                reserved.extend(need)
            if self._current is None:
                # first chunk admitted: the engine owns the request until
                # its final chunk installs
                self.scheduler.pop(req)
                self._current = req
            budget -= take
            self._prefilling[req.seq_id] = end
            final = end == total
            chunks.append((req, start, end, final))
            self.admission_log.append(ChunkRecord(
                req.seq_id, start, end, "recompute", end))
            if final:
                self._current = None

        # ---- bucket by padded prefix length; one dispatch per bucket ----
        pending: List[Tuple[Request, torch.Tensor]] = []
        buckets: Dict[int, list] = defaultdict(list)
        for req, start, end, final in chunks:
            buckets[bs * _next_pow2(end // bs)].append((req, start, end,
                                                        final))
        for s_pad, grp in sorted(buckets.items()):
            pending.extend(self._prefill_bucket(grp, s_pad))
        return pending

    def _chunk_vpns(self, req, start: int, end: int) -> List[int]:
        """Vpns a prompt chunk's bucket allocation will fault in (its
        unmapped covering blocks)."""
        m = self.manager
        bs = self.cfg.kv_block_size
        s = m.seq_slot(req.seq_id)
        cb0 = start // bs
        return [self.hybrid_cfg.vpn(s, cb) for cb in range(cb0, end // bs)
                if m.lookup(req.seq_id, cb)[0] < 0]

    def _capacity_ok(self, reserved, need) -> bool:
        """Exact dry-run: could the pool allocate ``reserved`` (this
        round's already-accepted vpns) plus ``need`` right now?"""
        return self.manager.alloc_ledger().reserve(list(reserved)
                                                   + list(need))

    def _others_hold_blocks(self, seq_id: int) -> bool:
        m = self.manager
        s = m.seq_slot(seq_id)
        nblk = self.hybrid_cfg.max_blocks_per_seq
        return any(vpn // nblk != s for vpn in m.blocks)

    def _footprint_blocks(self, req) -> int:
        """Whole-request KV footprint in blocks (prompt + all of
        max_new_tokens), clamped to the per-sequence maximum."""
        bs = self.cfg.kv_block_size
        total = len(np.asarray(req.prompt)) + req.max_new_tokens
        return min((total + bs - 1) // bs, self.spec.max_blocks_per_seq)

    def _footprint_admit(self, req) -> bool:
        """Fail-fast admission gate: admit only when the request's FULL
        footprint fits next to every resident sequence's.  Raises for a
        request whose footprint alone exceeds the pool."""
        m = self.manager
        need = self._footprint_blocks(req)
        cap = self.hybrid_cfg.total_slots
        if need > cap:
            raise PoolExhausted(
                f"request {req.seq_id} needs {need} KV blocks but the "
                f"pool only has {cap}", **self._pool_diag())
        held = 0
        nblk = self.spec.max_blocks_per_seq
        for sid in self._slot_of:
            st = self._states[sid]
            if st.done:        # finished-unreleased: count actual blocks
                held += sum(1 for b in range(nblk)
                            if m.lookup(sid, b)[0] >= 0)
            else:
                held += self._footprint_blocks(st.request)
        return held + need <= cap

    def _pool_diag(self) -> Dict[str, int]:
        """Structured occupancy diagnostics attached to PoolExhausted."""
        m = self.manager
        return dict(
            pool_blocks=self.hybrid_cfg.total_slots,
            mapped_blocks=sum(1 for i in m.blocks.values() if i.slot >= 0),
            free_flex=len(m.flex_free),
            queued=len(self.waiting),
            live=sum(1 for sid in self.requests
                     if not self._states[sid].done),
            finished_unreleased=sum(1 for sid in self._slot_of
                                    if self._states[sid].done))

    def _ensure_decode_blocks(self, st: RequestState) -> None:
        """Map the block the next decode dispatch writes for ``st`` (when
        its position sits on a block boundary).  A capacity miss raises
        ``PoolExhausted`` (fail-fast); ``restrictive_only`` swaps on a set
        conflict by design (Fig. 9)."""
        m = self.manager
        bs = self.cfg.kv_block_size
        sid = st.request.seq_id
        pos = int(self._ctx_host[self._slot_of[sid]])
        if pos % bs:
            return
        b = pos // bs
        bslot, seg = m.lookup(sid, b)
        if bslot >= 0:
            return
        if self.hybrid_cfg.mode == "restrictive_only":
            info = m.allocate_block(sid, b)
            if info.seg == SWAP:
                m.swap_in(sid, b)
                st.swap_faults += 1
            return
        vpn = self.hybrid_cfg.vpn(m.seq_slot(sid), b)
        if not self._capacity_ok((), (vpn,)):
            raise PoolExhausted(
                f"decode step cannot allocate a KV block for sequence "
                f"{sid}", **self._pool_diag())
        if seg == SWAP:
            m.swap_in(sid, b)
            st.swap_faults += 1
        else:
            m.allocate_block(sid, b)

    def _prefill_bucket(self, grp, s_pad: int):
        """Allocate blocks and run ONE batched prefill dispatch for a
        bucket of same-padded-length chunks."""
        m = self.manager
        bs = self.cfg.kv_block_size
        B_pad = _next_pow2(len(grp))
        nblk_cache = s_pad // bs
        tokens = np.zeros((B_pad, s_pad), np.int64)
        slots = -np.ones((B_pad, nblk_cache), np.int32)
        slot_ids = np.full(B_pad, -1, np.int32)
        ctx = np.zeros(B_pad, np.int32)
        last_pos = np.zeros(B_pad, np.int32)
        allocated: List[Tuple[int, int, int]] = []
        for i, (req, start, end, final) in enumerate(grp):
            prompt = np.asarray(req.prompt)
            tokens[i, :end] = prompt[:end]
            slot_ids[i] = self._slot_of[req.seq_id]
            ctx[i] = end
            last_pos[i] = end - 1
            # new cache blocks of this chunk; blocks an earlier chunk
            # mapped install nothing
            for cb in range(start // bs, end // bs):
                if m.lookup(req.seq_id, cb)[0] >= 0:
                    continue
                info = m.allocate_block(req.seq_id, cb)
                if info.seg == SWAP:
                    raise RuntimeError("pool exhausted during prefill")
                allocated.append((i, req.seq_id, cb))
        # allocation-time evictions queued copies: drain them first, then
        # RE-resolve every slot — a later allocation in the loop may have
        # evict-migrated an earlier block, and the install must write
        # where the block lives NOW
        self._apply_copies()
        for i, sid, cb in allocated:
            slots[i, cb] = m.lookup(sid, cb)[0]
        dev = self.device
        _, self.dstate, pstats = self._prefill_step(
            self.params, self.dstate, {"tokens": _upload(tokens, dev)},
            _upload(slots, dev), _upload(slot_ids, dev), _upload(ctx, dev),
            _upload(last_pos, dev))
        out = []
        for i, (req, start, end, final) in enumerate(grp):
            self._ctx_host[slot_ids[i]] = int(ctx[i])
            if final:
                out.append((req, pstats["next_token"][i:i + 1]))
        return out

    def _complete_prefill(self, req: Request, nxt: int) -> None:
        self._prefilling.pop(req.seq_id, None)
        st = self._states[req.seq_id]
        st.generated.append(nxt)
        st.new_tokens.append(nxt)
        self._maybe_finish(st, nxt)

    def _finish(self, st: RequestState, reason: str) -> None:
        st.done = True
        st.finish_reason = reason
        if self.auto_release and st.request.seq_id in self._slot_of:
            self.release(st.request.seq_id)

    def _maybe_finish(self, st: RequestState, nxt: int) -> None:
        if st.done:
            return
        req = st.request
        hit_eos = req.eos_token is not None and nxt == req.eos_token
        if hit_eos or len(st.generated) >= req.max_new_tokens:
            self._finish(st, "stop" if hit_eos else "length")

    # ------------------------------------------------------------- serving
    def _sync_translation(self, full: bool = False) -> None:
        """Upload TAR/SF/flex changes into the device tables, in place.

        The first call (or ``full=True``) uploads everything; afterwards
        only the entries dirtied since the previous sync are written."""
        m = self.manager
        dev = self.device
        flat = m.flex_table.reshape(-1)
        if full or not self._synced_full:
            m.take_dirty()             # everything is covered below
            self.dstate["tar"][0].copy_(_upload(m.tar, dev))
            self.dstate["sf"][0].copy_(_upload(m.sf, dev))
            self.dstate["flex"][0].copy_(_upload(flat, dev))
            self._synced_full = True
            return
        sets, flex_idx = m.take_dirty()
        if sets.size:
            idx = _upload(sets, dev)
            self.dstate["tar"][0, idx] = _upload(m.tar[sets], dev)
            self.dstate["sf"][0, idx] = _upload(m.sf[sets], dev)
        if flex_idx.size:
            self.dstate["flex"][0, _upload(flex_idx, dev)] = _upload(
                flat[flex_idx], dev)

    def _apply_copies(self) -> None:
        """Apply pending slot migrations as ONE gather/scatter per pool.

        Chains inside a drain (a->b, b->c) resolve host-side to the
        original source, so the batched gather reads pre-copy contents
        with sequential semantics."""
        copies = self.manager.take_pending_copies()
        if not copies:
            return
        root: Dict[int, int] = {}
        for src, dst in copies:
            root[dst] = root.get(src, src)
        pairs = [(d, s) for d, s in root.items() if d != s]
        if not pairs:
            return
        dst = _upload(np.asarray([d for d, _ in pairs], np.int64),
                      self.device)
        src = _upload(np.asarray([s for _, s in pairs], np.int64),
                      self.device)
        for key in ("k_pool", "v_pool"):
            pool = self.dstate[key]
            pool[:, dst] = pool[:, src]

    def step(self) -> Dict[int, int]:
        """One engine step: admit under the prefill budget, then decode
        all live sequences.  Returns {seq_id: token} for every sequence
        that produced a token (prefill completions AND decodes)."""
        self._step_count += 1
        pending = self._admit(self.prefill_budget)
        live = [self._states[sid] for sid in self.requests
                if not self._states[sid].done
                and sid not in self._prefilling]
        m = self.manager
        bs = self.cfg.kv_block_size
        nblk = self.spec.max_blocks_per_seq
        B = self.max_batch
        parts = [tok for _, tok in pending]
        want_stats = False
        if live:
            # map the blocks this dispatch will write FIRST
            for st in live:
                self._ensure_decode_blocks(st)
            tokens = np.zeros(B, np.int64)
            active = np.zeros(B, bool)
            for st in live:
                slot = self._slot_of[st.request.seq_id]
                active[slot] = True
                tokens[slot] = st.generated[-1]
            self._apply_copies()
            self._sync_translation()
            # pre-step context snapshot: the telemetry mask counts the
            # blocks that existed when the step TRANSLATED
            ctx_pre = self._ctx_host.copy()
            _, self.dstate, tstats = self._serve_step(
                self.params, self.dstate, _upload(tokens, self.device),
                _upload(active, self.device))
            parts += [tstats["next_token"], self.dstate["ctx_len"]]
            want_stats = self.track_stats
            if want_stats:
                parts += [tstats[k].reshape(-1).to(torch.int32)
                          for k in ("in_rest", "accesses", "mapped")]
        if not parts:
            return {}
        # ---- the step's ONE device->host copy ---------------------------
        host = torch.cat(parts).cpu().numpy()
        firsts, host = host[:len(pending)], host[len(pending):]

        out: Dict[int, int] = {}
        if live:
            nxt_all, ctx_all = host[:B], host[B:2 * B]
            self._ctx_host[:] = ctx_all
            if want_stats:
                in_rest, accesses, mapped = (
                    host[2 * B + i * B * nblk:2 * B + (i + 1) * B * nblk
                         ].reshape(B, nblk) for i in range(3))
                live_slots = [self._slot_of[st.request.seq_id]
                              for st in live]
                live_mask = np.zeros(B, bool)
                live_mask[live_slots] = True
                # pre-step block counts: blocks covering [0, pos], masked
                # by the device ``mapped`` flag
                n_pre = np.minimum(ctx_pre // bs + 1, nblk)
                valid = (live_mask[:, None]
                         & (np.arange(nblk)[None, :] < n_pre[:, None])
                         & mapped.astype(bool))
                vpns = (np.arange(B)[:, None] * nblk
                        + np.arange(nblk)[None, :])
                in_rest = in_rest.astype(bool)
                m.record_device_stats(vpns[valid], in_rest[valid],
                                      accesses[valid])
                hits_slot = (valid & in_rest).sum(axis=1)
                walks_slot = (valid & ~in_rest).sum(axis=1)
                for st, slot in zip(live, live_slots):
                    st.rsw_hits += int(hits_slot[slot])
                    st.flex_walks += int(walks_slot[slot])
                m.run_promotions()
                self._apply_copies()
            for st in live:
                sid = st.request.seq_id
                nxt = int(nxt_all[self._slot_of[sid]])
                st.generated.append(nxt)
                st.new_tokens.append(nxt)
                out[sid] = nxt
                self._maybe_finish(st, nxt)
        for (r, _), nxt in zip(pending, firsts):
            self._complete_prefill(r, int(nxt))
            out[r.seq_id] = int(nxt)
        return out

    # ---------------------------------------------------- streaming output
    @property
    def step_count(self) -> int:
        return self._step_count

    def poll(self) -> List[RequestOutput]:
        """Advance the engine one step (if any work remains) and return a
        ``RequestOutput`` per request that produced tokens or finished
        since the previous poll.  Raises ``PoolExhausted`` when a step
        makes no progress while requests are queued (every slot held by
        a finished-but-unreleased sequence)."""
        if self.has_unfinished():
            before = (dict(self._prefilling), len(self.waiting),
                      len(self._slot_of))
            out = self.step()
            if (not out and self.waiting
                    and before == (self._prefilling, len(self.waiting),
                                   len(self._slot_of))):
                raise PoolExhausted(
                    f"{len(self.waiting)} queued request(s) cannot be "
                    "admitted and nothing is decoding: release finished "
                    "sequences or construct the engine with "
                    "auto_release=True", **self._pool_diag())
        return self._drain_outputs()

    def stream(self):
        """Iterate ``RequestOutput`` snapshots until every submitted
        request finishes."""
        while self.has_unfinished():
            yield from self.poll()
        yield from self._drain_outputs()

    def _drain_outputs(self) -> List[RequestOutput]:
        outs = []
        for sid, st in self._states.items():
            if st.new_tokens or (st.done and not st.finish_reported):
                outs.append(RequestOutput(
                    seq_id=sid, new_token_ids=tuple(st.new_tokens),
                    token_ids=tuple(st.generated), finished=st.done,
                    finish_reason=st.finish_reason))
                st.new_tokens = []
                if st.done:
                    st.finish_reported = True
        return outs

    # ------------------------------------------------------------ teardown
    def release(self, seq_id: int) -> None:
        self.manager.free_sequence(seq_id)
        slot = self._slot_of.pop(seq_id)
        self.dstate["ctx_len"][slot] = 0
        self._ctx_host[slot] = 0
        req = self.requests.pop(seq_id, None)
        if req is not None:
            self.finished[seq_id] = req
        if self._current is not None and self._current.seq_id == seq_id:
            self._current = None
        self._prefilling.pop(seq_id, None)
        self._sync_translation()

    # ---------------------------------------------------------- telemetry
    def stats(self) -> dict:
        """Global manager counters plus ``"per_request"``: RestSeg hits /
        flexible walks / swap faults attributed to each seq_id."""
        s = dict(self.manager.stats)
        s["per_request"] = {
            sid: {"rsw_hits": st.rsw_hits, "flex_walks": st.flex_walks,
                  "swap_faults": st.swap_faults}
            for sid, st in self._states.items()}
        return s

    def check_invariants(self) -> None:
        """The manager's structural oracle, plus: the device translation
        tables equal the host tables."""
        self.manager.check_invariants()
        m = self.manager
        tar = self.dstate["tar"][0].cpu().numpy()
        sf = self.dstate["sf"][0].cpu().numpy()
        flex = self.dstate["flex"][0].cpu().numpy()
        assert (tar == m.tar).all(), "device TAR != host TAR"
        assert (sf == m.sf).all(), "device SF != host SF"
        assert (flex == m.flex_table.reshape(-1)).all(), \
            "device flex != host flex"
