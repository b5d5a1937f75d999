"""Request-centric continuous-batching engine over the hybrid KV pool.

The port of ``repro.serve.engine`` for the single-device path of its six
families.  A request runs like this:

* ``submit`` queues it; the configured :class:`~.scheduler.Scheduler`
  orders the waiting requests;
* at registration the longest cached prefix of its prompt attaches
  read-only from the content-addressed prefix cache
  (``core/prefix_cache.py``), and prefill starts at the tail;
* every ``step()`` admits prompts up to the per-step prefill token budget,
  chunked at KV-block granularity, bucketed into power-of-two padded
  lengths, with ONE prefill dispatch per bucket: chunk 0 runs the
  full-recompute forward, later chunks (``prefill_mode="prefix_kv"``, the
  default) forward only their own tokens and read the installed prefix
  from the pool; the installed chunks are published to the prefix cache
  after the dispatch;
* every steady decode step (i) maps the block each live sequence is about
  to write, (ii) uploads the dirty TAR/SF/flex entries to the device
  tables in place, (iii) runs the serve step — one RSW launch translates
  every block, each layer runs the paged-attention kernel — (iv) feeds the
  translation telemetry back to the manager (SRRIP hits, flexible-walk
  cost tracking, promotions) globally and per request, and (v) applies
  pending slot migrations as one batched gather/scatter per pool;
* a request ends at ``max_new_tokens`` ("length"), ``eos_token``
  ("stop"), ``Engine.cancel`` ("cancelled") or its ``deadline_ms``
  ("deadline"); with ``auto_release=True`` its slot and blocks free at
  once.

Tokens are the argmax, or for a request with sampled ``SamplingParams``
its seeded draw (``serve/sampling.py``).

Frontend families: a vlm request's ``frontend`` (its image embeddings)
occupies the first ``frontend_tokens`` positions of the sequence, so
context lengths, KV block indices, the footprint and the drafter's
history all count it (``_front_tokens``); an audio request's frames feed
the encoder in its recompute chunk 0, which installs the slot's
``cross_k``/``cross_v`` rows, and preemption and snapshots carry those
rows.  The prefix cache is off for both (``_prefix_cache_unsupported``).

Recurrent families (ssm, hybrid): every mamba sublayer keeps per-slot
``ssm``/``conv`` rows in the decode state; prefill installs them at the
row's real length (the pow2 buckets' pad tail is masked), prefix-KV
chunks continue from them, and preemption and snapshots carry them.  An
attention-free model (ssm) has no KV pool: nothing is allocated or
translated, and preemption saves the rows only.  Speculative decoding
falls back to the plain decode step with one warning (rejected drafts
would need a state rollback), and the prefix cache is off (see
``_prefix_cache_unsupported``).

Speculative decoding (``spec_decode="ngram"``, ``serve/spec_decode.py``):
each decode step drafts K tokens a row from the row's own token history,
verifies the K+1 window in one forward and commits up to K+1 tokens; the
streams are the non-speculative engine's, greedy and sampled.  The engine
keeps the history (``dstate["hist"]``, fed at admission), maps the
window's blocks before the step and, after it, truncates at eos /
``max_new_tokens`` / the KV capacity, rewinds ``ctx_len`` and frees the
blocks a rejected tail crossed into (``_commit_spec``).

Overload (``overload_policy="preempt"``, the default): when a KV block
cannot be allocated the engine walks the degradation ladder — reclaim
unreferenced prefix-cache entries, defer admission, PREEMPT a victim
sequence to the host KV tier (``preempt_request``: one gather of its pool
blocks and one device-to-host copy) — and rejects only requests that can
never run.  A preempted request re-enters the scheduler queue with its
original arrival and resumes (``_resume_preempted``: one host-to-device
copy and one scatter into fresh pool slots) bit-identically: sampling
keys derive from (seed, seq_id) and fold the absolute position.
``overload_policy="fail"`` is the fail-fast baseline: admission waits
until a request's whole footprint fits and a decode-time miss raises
``PoolExhausted``.  A ``runtime.fault.ServeFaultInjector`` can force
allocation denials, preemptions and crashes at the step's safe points.

Recovery: ``snapshot()`` captures the whole serving state as one
``EngineSnapshot`` (the decode-state tensors, copied to the host in one
batch, and one pickle of the host side); ``restore()`` writes it back in
place (``runtime/resilient_serve.py`` restores and replays after a
crash).  ``EngineConfig.metrics`` takes a ``serve.metrics.MetricsLogger``
fed one host-side event per step.

Host contract: a step performs ONE device-to-host copy.  The next
tokens (under speculative decoding each row's K+1 window tokens and its
emitted count), the post-step context lengths, the translation telemetry and the
first tokens of every prefill that completed this step are packed into one
int32 tensor and copied with a single ``.cpu()``; a preemption adds its
own copy only when a victim is actually swapped.

The JAX engine's legacy API works as there, warnings included:
``Engine(cfg, params, **kwargs)``, ``submit(req, share_prefix_from=,
shared_blocks=)`` (accepted, no-op) and the blocking ``add_request``.

Features of the JAX engine that are not ported yet keep their
``EngineConfig`` fields, accept only the value that turns them off and
raise ``NotImplementedError`` naming the ROADMAP item otherwise.
"""
from __future__ import annotations

import dataclasses
import pickle
import time
import warnings
from collections import defaultdict
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import (CHAIN_SEED, HybridConfig, HybridKVManager,
                              PoolExhausted, PrefixCache, SWAP,
                              block_hash_chain)
from repro_torch.models import FwdOptions, model_dims
from repro_torch.models.transformer import (RECURRENT_FAMILIES, check_family,
                                            n_attn_layers)
from .decode import (DecodeSpec, init_decode_state, make_serve_step,
                     probe_verify_gemms)
from .decode import not_ported as _not_ported
from .prefill import make_prefill_step, make_prefix_prefill_step
from .sampling import GREEDY, SamplingParams, prng_key_data
from .scheduler import Scheduler, default_victim, make_scheduler
from .spec_decode import make_spec_decode_step


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


# ------------------------------------------------------------- request API

@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine construction options (the JAX engine's fields).

    ``scheduler`` is a policy name (``"fifo"`` / ``"spf"`` /
    ``"priority"``), a ready Scheduler instance, or a zero-arg factory.
    ``prefill_budget`` is NEW prompt tokens admitted per step (None =
    ``4 * block_size * max_batch``).  ``attn_impl`` picks the recompute
    prefill's causal attention: ``"dense"`` (the plain version, the JAX
    default) or ``"pallas"`` (the JAX name of the flash kernel: the port's
    CUDA flash kernel on the card, its plain version on the CPU), also
    called ``"flash"``, or ``"flash_jax"`` (the JAX package's chunked
    eager attention, ``models.attention.flash_attention_jax``).  ``dtype``
    is the activation and KV-pool dtype.

    ``prefill_mode``: ``"prefix_kv"`` (chunks k > 0 forward only their
    own tokens and read the installed prefix from the pool) or
    ``"recompute"`` (every chunk re-forwards its whole prefix, the
    oracle); ``prefix_kv`` is defined against the dense softmax, so with
    any other ``attn_impl`` it warns and falls back to ``"recompute"``.
    ``prefix_gather``: how a prefix-KV chunk reads the pool, ``"exact"``
    (gathered blocks, dense softmax; equal to recompute) or ``"paged"``
    (the paged-attention kernel with Q = chunk length, merged with the
    chunk's own causal part).  ``prefix_cache``: ``"auto"`` (a
    ``PrefixCache`` where the configuration supports one), True (demand
    one), None/False (off) or a ready ``PrefixCache``.

    ``overload_policy``: ``"preempt"`` (swap a victim sequence out to
    the host KV tier when a block cannot be allocated) or ``"fail"``
    (footprint-gated admission; a decode-time miss raises
    ``PoolExhausted``).  ``fault_injector``: a
    ``runtime.fault.ServeFaultInjector`` or None.  ``metrics``: a
    ``serve.metrics.MetricsLogger`` or None.

    ``spec_decode``: None/False (off) or ``"ngram"`` (True is ``"ngram"``),
    speculative decoding with ``num_draft_tokens`` drafts a step from the
    prompt-lookup drafter of order ``spec_ngram``.

    The defaults are the JAX engine's.  Not ported yet, off-values only:
    ``mesh_shape=None`` (P15).
    """
    max_batch: int = 4
    max_seq_len: int = 256
    pool_headroom: float = 1.25
    mode: str = "hybrid"
    attn_impl: str = "dense"
    dtype: Any = torch.float32
    restseg_fraction: float = 0.75
    track_stats: bool = True
    prefill_budget: Optional[int] = None
    auto_release: bool = False
    scheduler: Any = "fifo"
    prefill_mode: str = "prefix_kv"
    prefix_gather: str = "exact"
    spec_decode: Any = None
    num_draft_tokens: int = 4
    spec_ngram: int = 2
    overload_policy: str = "preempt"
    fault_injector: Any = None
    mesh_shape: Optional[Tuple[int, int]] = None
    prefix_cache: Any = "auto"
    metrics: Any = None

    def check_ported(self) -> None:
        """Raise for a field set to a feature the port does not run yet,
        and for the values the JAX engine refuses."""
        if self.mesh_shape is not None:
            raise _not_ported("sharded serving (mesh_shape)", "P15")
        if self.attn_impl not in ("dense", "flash_jax", "pallas", "flash"):
            raise ValueError(f"unknown attn_impl {self.attn_impl!r} "
                             "(expected 'dense', 'flash_jax' or 'pallas')")
        if self.spec_decode not in (None, False, True, "ngram"):
            raise ValueError(f"unknown spec_decode drafter "
                             f"{self.spec_decode!r} (expected None/False "
                             "or 'ngram')")
        if self.spec_decode:
            if self.num_draft_tokens < 1:
                raise ValueError("num_draft_tokens must be >= 1, got "
                                 f"{self.num_draft_tokens}")
            if self.spec_ngram < 1:
                # a non-positive n-gram would degrade the drafter to
                # repeating the current token
                raise ValueError("spec_ngram must be >= 1, got "
                                 f"{self.spec_ngram}")
        if self.prefill_mode not in ("prefix_kv", "recompute"):
            raise ValueError(f"unknown prefill_mode {self.prefill_mode!r}"
                             " (expected 'prefix_kv' or 'recompute')")
        if self.overload_policy not in ("preempt", "fail"):
            raise ValueError(
                f"unknown overload_policy {self.overload_policy!r} "
                "(expected 'preempt' or 'fail')")


class ChunkRecord(NamedTuple):
    """One admitted prompt chunk in ``Engine.admission_log``.

    ``fwd_tokens`` is the number of tokens fed through the chunk forward:
    ``end - start`` on the prefix-KV path (constant in chunk index),
    ``end`` on the recompute path (grows with every chunk)."""
    seq_id: int
    start: int
    end: int
    path: str          # "recompute" | "prefix_kv"
    fwd_tokens: int


@dataclasses.dataclass(frozen=True, eq=False)
class Request:
    """Immutable request submission.  The prompt (and frontend) arrays are
    copied and marked read-only; ``frontend`` holds a vlm or audio
    request's stub embeddings ``(frontend_tokens, d_model)``.  Runtime
    state lives in the engine's
    ``RequestState`` and surfaces through ``RequestOutput`` snapshots.

    ``deadline_ms`` is a wall-clock budget from submission (None = no
    deadline): ``poll()`` cancels the request wherever it is (queued,
    mid-chunk prefill, decoding, or parked on the host tier) once it
    elapses, and the stream finishes with ``finish_reason="deadline"``.
    The clock is the monotonic ``time.perf_counter``; across a
    snapshot/restore the REMAINING budget carries over."""
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
        if self.frontend is not None:
            f = np.array(self.frontend, copy=True)
            f.setflags(write=False)
            object.__setattr__(self, "frontend", f)

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
    # "stop" | "length" | "cancelled" | "deadline"
    finish_reason: Optional[str] = None
    # absolute monotonic deadline (perf_counter seconds), set at submit
    # from Request.deadline_ms; snapshot/restore rebases it so only the
    # remaining budget survives a crash
    deadline_at: Optional[float] = None
    new_tokens: List[int] = dataclasses.field(default_factory=list)
    finish_reported: bool = False
    # per-request translation telemetry (stats()["per_request"])
    rsw_hits: int = 0
    flex_walks: int = 0
    swap_faults: int = 0
    # speculative decoding: drafts proposed for / accepted into this
    # stream (the rows sum to the global spec_drafted / spec_accepted)
    drafted: int = 0
    accepted: int = 0
    cached_blocks: int = 0           # prompt blocks attached from the cache
    # overload bookkeeping: step of the latest decode commit (the LRU key
    # of victim selection) and how often this request was preempted /
    # resumed.  stats()["overload"] keeps separate monotone engine
    # counters: a finished request's row is dropped on seq_id reuse
    last_step: int = 0
    preempts: int = 0
    resumes: int = 0


@dataclasses.dataclass
class _HostTierSeq:
    """One preempted sequence parked in host memory (the KV tier).

    Everything it needs to continue bit-identically: the pool blocks it
    had mapped (``kv``, a host tensor (2 = k/v, layers, n_blocks, block,
    KV heads, head dim) in the pool dtype, a bitwise copy), under
    speculative decoding its token-history row (``hist``), for a recurrent
    family its ``ssm``/``conv`` rows and for the audio family its
    ``cross_k``/``cross_v`` rows (``rows``), the committed context
    length and, for a mid-prefill victim, how many prompt tokens were
    installed.  Sampling state needs no save: per-slot keys derive
    from (seed, seq_id) and fold the absolute position, so they are
    re-scattered on resume."""
    seq_id: int
    ctx: int
    prefill_progress: Optional[int]     # tokens installed, None = done
    blocks: List[Tuple[int, bool]]      # (block_idx, writable) at preempt
    kv: Optional[torch.Tensor]
    nbytes: int
    hist: Optional[torch.Tensor] = None
    # the slot's ``ssm``/``conv`` rows (n_ssm, ...) of a recurrent family,
    # its ``cross_k``/``cross_v`` rows (L, F, KV, hd) of the audio family
    rows: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class RequestOutput:
    """Streaming snapshot for one request, drained by ``Engine.poll()``:
    the tokens produced since the previous poll, all tokens so far, and
    once finished the reason (``"stop"``, ``"length"``, ``"cancelled"``
    or ``"deadline"``)."""
    seq_id: int
    new_token_ids: Tuple[int, ...]
    token_ids: Tuple[int, ...]
    finished: bool
    finish_reason: Optional[str]


# ------------------------------------------------------- crash-safe snapshot

SNAPSHOT_VERSION = 1
# the translation tables are functions of the manager's host tables: a
# snapshot stores the host tables, and restore re-uploads them
_TRANSLATION = ("tar", "sf", "flex")


@dataclasses.dataclass(frozen=True)
class EngineSnapshot:
    """The whole serving state at a step boundary.

    ``dstate`` holds HOST copies (CPU tensors) of every decode-state
    tensor except the TAR/SF/flex translation tables: the manager's host
    tables inside ``host_blob`` are authoritative for those, and
    ``Engine.restore`` re-uploads them through the full translation sync.
    ``host_blob`` pickles the whole host side in one dump (manager, prefix
    cache, scheduler, request states, the host KV tier, monotone
    counters), so shared references (the cache's manager, a ``Request``
    held by both the scheduler queue and the states) survive as the SAME
    object on restore.

    ``to_arrays``/``from_arrays`` flatten it to ``{name: ndarray}``
    (numpy has no bfloat16: such tensors travel as their int16 bits under
    a ``:bf16`` key suffix)."""
    version: int
    step: int
    dstate: Dict[str, torch.Tensor]
    host_blob: bytes

    def to_arrays(self) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {
            "meta": np.asarray([self.version, self.step], np.int64),
            "host": np.frombuffer(self.host_blob, np.uint8),
        }
        for k, v in self.dstate.items():
            if v.dtype == torch.bfloat16:
                out[f"d.{k}:bf16"] = v.view(torch.int16).numpy()
            else:
                out[f"d.{k}"] = v.numpy()
        return out

    @classmethod
    def from_arrays(cls, arrays: Dict[str, np.ndarray]
                    ) -> "EngineSnapshot":
        meta = np.asarray(arrays["meta"])
        dstate = {}
        for k, v in arrays.items():
            if not k.startswith("d."):
                continue
            t = torch.from_numpy(np.array(v, copy=True))
            if k.endswith(":bf16"):
                dstate[k[2:-5]] = t.view(torch.bfloat16)
            else:
                dstate[k[2:]] = t
        return cls(version=int(meta[0]), step=int(meta[1]), dstate=dstate,
                   host_blob=np.asarray(arrays["host"]).tobytes())


# ------------------------------------------------------------ legacy API

_LEGACY_KWARGS_WARNED = False
_SHARE_KWARG_WARNED = False
_SPEC_FALLBACK_WARNED = False


def _warn_spec_fallback(family: str) -> None:
    global _SPEC_FALLBACK_WARNED
    if _SPEC_FALLBACK_WARNED:
        return
    _SPEC_FALLBACK_WARNED = True
    warnings.warn(
        f"speculative decoding is not supported for recurrent family "
        f"{family!r} (ssm/conv state rollback for rejected drafts is "
        "not cheap — ROADMAP item); falling back to non-speculative "
        "decode", stacklevel=3)


def _warn_share_kwarg() -> None:
    global _SHARE_KWARG_WARNED
    if _SHARE_KWARG_WARNED:
        return
    _SHARE_KWARG_WARNED = True
    warnings.warn(
        "submit(share_prefix_from=..., shared_blocks=...) is deprecated: "
        "the engine's content-addressed prefix cache "
        "(EngineConfig.prefix_cache, on by default) dedupes shared "
        "prompt prefixes automatically — the kwargs are accepted but "
        "the cache decides what is shared; with the cache disabled the "
        "prompt is simply recomputed (sharing was always best-effort)",
        DeprecationWarning, stacklevel=3)


def _warn_legacy_kwargs(kwargs) -> None:
    global _LEGACY_KWARGS_WARNED
    if _LEGACY_KWARGS_WARNED:
        return
    _LEGACY_KWARGS_WARNED = True
    warnings.warn(
        f"Engine(cfg, params, {', '.join(sorted(kwargs))}=...) kwargs are "
        "deprecated; pass Engine(cfg, params, EngineConfig(...)) instead",
        DeprecationWarning, stacklevel=3)


# ------------------------------------------------------------------ engine

class Engine:
    """Continuous-batching engine on ``device`` (default ``"cuda"``).

    ``params`` must already live on ``device`` (``params.init_params`` or
    ``params.params_from_numpy``).  ``EngineConfig`` fields given as
    keyword arguments instead of ``config`` (the JAX engine's legacy form)
    build the config, with a deprecation warning once a process."""

    def __init__(self, cfg: ArchConfig, params,
                 config: Optional[EngineConfig] = None, device="cuda",
                 **legacy):
        if legacy:
            if config is not None:
                raise TypeError("pass an EngineConfig OR legacy kwargs, "
                                "not both")
            known = {f.name for f in dataclasses.fields(EngineConfig)}
            unknown = set(legacy) - known
            if unknown:
                raise TypeError(f"unknown Engine kwargs {sorted(unknown)}")
            _warn_legacy_kwargs(legacy)
            config = EngineConfig(**legacy)
        config = config if config is not None else EngineConfig()
        config.check_ported()
        check_family(cfg)
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
        self.prefill_mode = config.prefill_mode
        if self.prefill_mode == "prefix_kv" and config.attn_impl != "dense":
            # the prefix chunk forward implements the dense softmax; mixing
            # it with a flash chunk-0 forward would let chunk k>0 drift from
            # the recompute oracle in float summation order
            warnings.warn(
                f"prefix-KV chunked prefill is defined against the dense "
                f"attention forward; falling back to "
                f"prefill_mode='recompute' for attn_impl="
                f"{config.attn_impl!r}", stacklevel=2)
            self.prefill_mode = "recompute"
        self.spec = DecodeSpec(
            block_size=bs, max_blocks_per_seq=max_blocks,
            slots_per_group=self.hybrid_cfg.total_slots,
            n_sets=self.hybrid_cfg.num_sets, assoc=self.hybrid_cfg.assoc,
            mode="batch", hash_name=self.hybrid_cfg.hash_name,
            prefix_gather=config.prefix_gather)
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
        self.overload_policy = config.overload_policy
        self._injector = config.fault_injector
        # host KV tier: preempted sequences parked off the device
        self._preempted: Dict[int, _HostTierSeq] = {}
        self._swap_bytes_out = 0
        self._swap_bytes_in = 0
        # swap traffic per KV shard; one shard on a single device (the
        # sharded split is ROADMAP P15).  The rows sum to the globals
        self._shard_swap_out = np.zeros(1, np.int64)
        self._shard_swap_in = np.zeros(1, np.int64)
        # monotone count of preempt/resume/cancel events: poll()'s
        # no-progress guard counts any of them as progress
        self._progress_events = 0
        # monotone engine-level preempt/resume counters (not sums over
        # the per-request rows, which seq_id reuse drops; the dropped
        # share is banked: sum(rows) + dropped == global)
        self._request_preempts = 0
        self._request_resumes = 0
        self._dropped_preempts = 0
        self._dropped_resumes = 0
        # monotone count of tokens committed to any stream (the metrics
        # logger's tokens delta)
        self._tokens_emitted = 0
        # request-lifecycle counters: explicit cancels, deadline expiries
        self._cancelled = 0
        self._deadline_expired = 0
        self.metrics = config.metrics
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
        bound = {}       # translation bindings, shared by the decode steps
        self._serve_step = make_serve_step(cfg, self.dims, self.spec,
                                           dtype=dtype, bound=bound)
        # ---- speculative decoding (serve/spec_decode.py) ----------------
        self.spec_K = 0
        if config.spec_decode and cfg.family in RECURRENT_FAMILIES:
            # state rollback for rejected drafts is not cheap: warn once
            # and keep the non-speculative step
            _warn_spec_fallback(cfg.family)
        elif config.spec_decode:
            self.spec_K = int(config.num_draft_tokens)
            self._spec_step = make_spec_decode_step(
                cfg, self.dims, self.spec, self.spec_K, dtype=dtype,
                ngram=config.spec_ngram, bound=bound)
            probe_verify_gemms(params, cfg, max_batch, self.spec_K + 1,
                               dtype)
            # each slot's token history for the drafter (prompt scattered
            # at admission, accepted tokens appended by the step; -1 =
            # unknown)
            self.dstate["hist"] = torch.full(
                (max_batch, max_seq_len), -1, dtype=torch.int32,
                device=self.device)
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._prefill_step = make_prefill_step(cfg, self.dims, self.spec,
                                               fwd=self.fwd)
        self._prefix_step = make_prefix_prefill_step(cfg, self.dims,
                                                     self.spec, fwd=self.fwd)
        self.requests: Dict[int, Request] = {}      # registered, live
        self.finished: Dict[int, Request] = {}
        self._states: Dict[int, RequestState] = {}
        self._current: Optional[Request] = None     # mid-chunk prefill
        self._slot_of: Dict[int, int] = {}
        self._prefilling: Dict[int, int] = {}   # seq_id -> tokens installed
        # newly registered (batch slot, request) whose SamplingParams are
        # not on the device yet
        self._pending_samp: List[Tuple[int, Request]] = []
        self._step_count = 0                    # scheduler clock (aging)
        self.admission_log: List[ChunkRecord] = []
        # host mirror of ctx_len: block-boundary checks never read the
        # device tensor
        self._ctx_host = np.zeros(max_batch, np.int64)
        self._synced_full = False
        self._n_attn_layers = n_attn_layers(cfg)
        self._has_recurrent = cfg.family in RECURRENT_FAMILIES
        # ---- the content-addressed prefix cache -------------------------
        pc = config.prefix_cache
        reason = self._prefix_cache_unsupported()
        if pc is True and reason is not None:
            raise ValueError(f"prefix_cache=True is unsupported here: "
                             f"{reason}")
        self.prefix_cache: Optional[PrefixCache] = None
        if pc not in (None, False) and reason is None:
            self.prefix_cache = (pc if isinstance(pc, PrefixCache)
                                 else PrefixCache(self.manager))
        # per-request memo of the prompt's block chain hashes (used by the
        # registration-time match and the post-dispatch inserts)
        self._chain_cache: Dict[int, np.ndarray] = {}

    def _prefix_cache_unsupported(self) -> Optional[str]:
        """Why the prefix cache cannot run on this configuration (None =
        supported).  ``prefix_cache="auto"`` silently disables on these;
        ``prefix_cache=True`` raises with the reason.

        Two deliberate differences from the JAX engine, which keeps the
        cache on for both and serves such a hit otherwise than cache-off:
        a family with recurrent layers is refused (a hit starts prefill at
        the prompt's tail, but the mamba sublayers' state at the cached
        prefix's end is not cached, so they would continue from whatever
        the slot's rows hold), and so is the audio family (the block hash
        covers the prompt tokens only, while the decoder's K/V depend on
        the request's encoder input too; and a hit's prefix-KV chunk reads
        ``cross_k``/``cross_v`` rows that no chunk installed for it)."""
        if not self._n_attn_layers:
            return ("the model family has no attention KV blocks to "
                    "cache")
        if self._has_recurrent:
            return ("the recurrent layers' state at a cached prefix's end "
                    "is not cached")
        if self.hybrid_cfg.mode == "restrictive_only":
            return ("content sharing needs a flexible segment (a "
                    "restrictive slot is tag-bound to a single vpn)")
        if self._front_tokens():
            return ("vlm frontend KV blocks precede the prompt blocks, "
                    "so prompt-block indices are not content-pure")
        if self.cfg.is_encoder_decoder:
            return ("the decoder's K/V depend on the request's encoder "
                    "input, which the block hash does not cover")
        return None

    def _front_tokens(self) -> int:
        """Frontend tokens that occupy KV blocks (the vlm image prefix; the
        audio frontend lives in the encoder, not the decoder cache)."""
        return self.cfg.frontend_tokens if self.cfg.family == "vlm" else 0

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

    def submit(self, req: Request, share_prefix_from: Optional[int] = None,
               shared_blocks: int = 0) -> None:
        """Enqueue a request; ``step()`` admits it under the token budget
        in the order the configured scheduler decides.  A ``seq_id`` may
        be reused once its previous request finished and was released.

        ``share_prefix_from`` / ``shared_blocks`` are the JAX engine's
        legacy pairwise sharing: accepted with a deprecation warning once a
        process, and otherwise ignored (the prefix cache attaches the same
        blocks at admission)."""
        bs = self.cfg.kv_block_size
        S = len(np.asarray(req.prompt))
        if S == 0:
            raise ValueError("empty prompt: an unadmittable request would "
                             "stall the queue head forever")
        if S % bs:
            raise ValueError(f"prompt length {S} must be a multiple of the "
                             f"KV block size {bs} (pad upstream)")
        front = self._front_tokens()
        if front % bs:
            raise ValueError(f"frontend length {front} must be a multiple "
                             f"of the KV block size {bs}")
        want = ((self.cfg.frontend_tokens, self.cfg.d_model)
                if self.cfg.frontend != "none" else None)
        got = None if req.frontend is None else req.frontend.shape
        if got != want:
            raise ValueError(f"request frontend of shape {got}, the model "
                             f"takes {want}")
        old = self._states.get(req.seq_id)
        if old is not None and not old.done:
            raise ValueError(f"seq_id {req.seq_id} is already queued or "
                             "live")
        if req.seq_id in self._slot_of:
            raise ValueError(
                f"seq_id {req.seq_id} finished but still holds its "
                f"sequence slot; call release({req.seq_id}) first or "
                "construct the engine with auto_release=True")
        if old is not None:
            # the old incarnation's row is about to be dropped: bank its
            # preempt/resume counts (sum(rows) + dropped == global)
            self._dropped_preempts += old.preempts
            self._dropped_resumes += old.resumes
        self.finished.pop(req.seq_id, None)
        self._chain_cache.pop(req.seq_id, None)   # fresh chains on reuse
        if share_prefix_from is not None and shared_blocks:
            _warn_share_kwarg()
        state = RequestState(request=req, arrival=self._step_count)
        if req.deadline_ms is not None:
            if req.deadline_ms < 0:
                raise ValueError(f"deadline_ms must be >= 0, got "
                                 f"{req.deadline_ms}")
            state.deadline_at = time.perf_counter() + req.deadline_ms / 1e3
        object.__setattr__(req, "_engine_state", state)
        self._states[req.seq_id] = state
        self.scheduler.add(req, state.arrival)
        if self.metrics is not None:
            self.metrics.on_submit(req.seq_id, self._step_count)

    def add_request(self, req: Request,
                    share_prefix_from: Optional[int] = None,
                    shared_blocks: int = 0) -> int:
        """Legacy blocking admission: enqueue, then prefill the whole
        prompt at once (and everything queued ahead of it), with one
        device-to-host copy of the first tokens.  Returns the request's
        batch slot; raises ``PoolExhausted`` when no slot is free."""
        self.submit(req, share_prefix_from, shared_blocks)
        pending = self._admit(budget=None)
        stuck = any(r is req for r in self.waiting)   # could not register
        # the slot is read before an auto-release can free it
        slot = None if stuck else self._slot_of[req.seq_id]
        if pending:
            # (requests queued ahead of it complete even when it is stuck)
            firsts = torch.cat([t for _, t in pending]).cpu().numpy()
            for (r, _), nxt in zip(pending, firsts):
                self._complete_prefill(r, int(nxt))
        if stuck:
            raise PoolExhausted("no free sequence slot for blocking "
                                "add_request; release a sequence first")
        return slot

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
        front = self._front_tokens()
        if budget is None:
            budget = sum(len(np.asarray(r.prompt)) for r in self.waiting)
        chunks: List[Tuple[Request, int, int, bool]] = []
        # spans of cache-attached prefixes, for the drafter history (no
        # chunk covers them)
        hist_extra: List[Tuple[Request, int, int, bool, bool]] = []
        # exact capacity gating: every accepted chunk's unmapped covering
        # blocks are reserved against a dry-run ledger BEFORE the chunk is
        # committed, so the bucket allocations below never exhaust the pool
        reserved: List[int] = []
        gate_alloc = (self._n_attn_layers > 0
                      and self.hybrid_cfg.mode != "restrictive_only")
        while budget >= bs:
            req = self._current
            if req is None:
                req = self.scheduler.select(self._step_count)
                if req is None:
                    break
                if req.seq_id in self._preempted:
                    # a preempted sequence re-entered through the queue:
                    # resume restores its saved blocks, charging no
                    # prefill budget (nothing is re-forwarded)
                    if not self._resume_preempted(
                            req, reserved, {c[0].seq_id for c in chunks}):
                        break              # no slot / no capacity yet
                    if req.seq_id not in self._prefilling:
                        continue           # decode-live again this step
                    req = self._current    # mid-prefill: keep chunking
            if req.seq_id not in self._slot_of:
                if not m._free_seq_slots:
                    break                      # wait for a release
                if (self.overload_policy == "fail" and gate_alloc
                        and not self._footprint_admit(req)):
                    break          # fail-fast: serve only what fits whole
                slot = m.register_sequence(req.seq_id)
                self._slot_of[req.seq_id] = slot
                self.requests[req.seq_id] = req
                self._prefilling[req.seq_id] = 0
                self._pending_samp.append((slot, req))
                if self.prefix_cache is not None:
                    self._attach_cached_prefix(req, hist_extra)
            start = self._prefilling[req.seq_id]
            total = len(np.asarray(req.prompt))
            take = min(total - start, budget // bs * bs)
            if take <= 0:
                break
            end = start + take
            if gate_alloc:
                need = self._chunk_vpns(req, start, end, front)
                if (need and self._injector is not None
                        and self._injector.alloc_unavailable(
                            self._step_count, "admit")):
                    break      # injected transient denial: defer a step
                if need and not self._capacity_ok(reserved, need):
                    if (not reserved
                            and not self._others_hold_blocks(req.seq_id)):
                        # nothing else holds pool blocks, yet this prompt
                        # does not fit: no preemption can ever admit it
                        raise PoolExhausted(
                            f"request {req.seq_id}'s prompt alone "
                            "exceeds the KV pool and cannot be admitted",
                            **self._pool_diag())
                    if (self.overload_policy != "preempt"
                            or not self._make_room(
                                self._states[req.seq_id], reserved, need,
                                exclude={c[0].seq_id for c in chunks}
                                | {req.seq_id})):
                        break          # defer: stay queued / mid-prefill
                reserved.extend(need)
            if self._current is None:
                # first chunk admitted: the engine owns the request until
                # its final chunk installs
                self.scheduler.pop(req)
                self._current = req
            budget -= take
            self._prefilling[req.seq_id] = end
            final = end == total
            # chunk 0 has no prefix to read; later chunks (and the first
            # chunk after a cache hit) read the installed prefix unless
            # the oracle mode forces recompute
            use_prefix = self.prefill_mode == "prefix_kv" and start > 0
            chunks.append((req, start, end, final, use_prefix))
            self.admission_log.append(ChunkRecord(
                req.seq_id, start, end,
                "prefix_kv" if use_prefix else "recompute",
                (end - start) if use_prefix else front + end))
            if final:
                self._current = None

        # newly registered sequences' SamplingParams must be on the device
        # before any prefill dispatch samples a first token, and under
        # speculative decoding the admitted prompt tokens must be in the
        # drafter's history
        self._install_sampling()
        self._install_hist(chunks + hist_extra)

        # ---- bucket by padded length; one dispatch per bucket -----------
        # recompute chunks bucket by padded PREFIX length, prefix-KV chunks
        # by padded CHUNK length and the prefix read-buffer width
        pending: List[Tuple[Request, torch.Tensor]] = []
        buckets: Dict[int, list] = defaultdict(list)
        pbuckets: Dict[Tuple[int, int], list] = defaultdict(list)
        for req, start, end, final, use_prefix in chunks:
            if use_prefix:
                s_pad = bs * _next_pow2((end - start) // bs)
                # the read-buffer width is the padded KV extent the
                # recompute forward would pad THIS row to (float
                # reductions nest bitwise across pow2 tails, not across
                # arbitrary length pairs): part of the bucket key, not a
                # bucket maximum
                nblk_buf = front // bs + _next_pow2(end // bs)
                pbuckets[(s_pad, nblk_buf)].append((req, start, end, final))
            else:
                buckets[bs * _next_pow2(end // bs)].append(
                    (req, start, end, final))
        for s_pad, grp in sorted(buckets.items()):
            pending.extend(self._prefill_bucket(grp, s_pad, front))
        for (s_pad, nblk_buf), grp in sorted(pbuckets.items()):
            pending.extend(self._prefix_bucket(grp, s_pad, nblk_buf, front))
        # ---- publish installed chunks to the prefix cache ---------------
        # after the dispatch: entries become matchable from the next
        # admission round, so a same-round duplicate never attaches a
        # block whose install has not run, and the pin migrations' copies
        # land with the next _apply_copies before anything reads them
        if self.prefix_cache is not None:
            for req, start, end, final, use_prefix in chunks:
                self._cache_insert_chunk(req, start, end)
        return pending

    def _chunk_vpns(self, req, start: int, end: int,
                    front: int) -> List[int]:
        """Vpns a prompt chunk's bucket allocation will fault in (its
        unmapped covering blocks, the frontend's on chunk 0)."""
        m = self.manager
        bs = self.cfg.kv_block_size
        s = m.seq_slot(req.seq_id)
        cb0 = (front + start) // bs if start else 0
        return [self.hybrid_cfg.vpn(s, cb)
                for cb in range(cb0, (front + end) // bs)
                if m.lookup(req.seq_id, cb)[0] < 0]

    # --------------------------------------------- prefix cache plumbing
    def _chains(self, req: Request) -> np.ndarray:
        """Memoized per-block chain hashes of a request's prompt."""
        c = self._chain_cache.get(req.seq_id)
        if c is None:
            c = block_hash_chain(np.asarray(req.prompt),
                                 self.cfg.kv_block_size)
            self._chain_cache[req.seq_id] = c
        return c

    def _attach_cached_prefix(self, req: Request, hist_extra) -> None:
        """Longest-cached-prefix match at registration: matched blocks
        attach read-only and prefill starts at the tail.  The match is
        capped one block short of the prompt, so the FINAL chunk always
        runs: it produces the request's first-token logits.  Under
        speculative decoding the attached span joins ``hist_extra``: the
        tail's chunks never cover its tokens."""
        pc = self.prefix_cache
        m = self.manager
        bs = self.cfg.kv_block_size
        pc.stats["lookups"] += 1
        prompt = np.asarray(req.prompt)
        entries = pc.match(prompt, self._chains(req))
        entries = entries[:len(prompt) // bs - 1]
        if not entries:
            return
        for cb, e in enumerate(entries):
            m.attach_cached_block(req.seq_id, cb, e.slot)
        self._prefilling[req.seq_id] = len(entries) * bs
        self._states[req.seq_id].cached_blocks += len(entries)
        pc.stats["hits"] += 1
        pc.stats["dedup_blocks"] += len(entries)
        if self.spec_K:
            hist_extra.append((req, 0, len(entries) * bs, False, False))

    def _cache_insert_chunk(self, req: Request, start: int,
                            end: int) -> None:
        """Publish a freshly installed chunk's blocks to the cache (one
        parent-chained insert per covered block; dedup and full-set bypass
        are the cache's business)."""
        bs = self.cfg.kv_block_size
        chains = self._chains(req)
        prompt = np.asarray(req.prompt)
        for cb in range(start // bs, end // bs):
            parent = CHAIN_SEED if cb == 0 else int(chains[cb - 1])
            self.prefix_cache.insert(
                int(chains[cb]), parent, prompt[cb * bs:(cb + 1) * bs],
                req.seq_id, cb)

    def _capacity_ok(self, reserved, need) -> bool:
        """Exact dry-run: could the pool allocate ``reserved`` (this
        round's already-accepted vpns) plus ``need`` right now?  A miss
        first reclaims UNREFERENCED prefix-cache entries (the cheapest
        rung: dropping clean cache frees one FlexSeg slot each) and
        re-runs the dry-run against a fresh ledger."""
        want = list(reserved) + list(need)
        while True:
            if self.manager.alloc_ledger().reserve(want):
                return True
            if (self.prefix_cache is None
                    or not self.prefix_cache.evict_one()):
                return False

    def _others_hold_blocks(self, seq_id: int) -> bool:
        m = self.manager
        s = m.seq_slot(seq_id)
        nblk = self.hybrid_cfg.max_blocks_per_seq
        return any(vpn // nblk != s for vpn in m.blocks)

    # -------------------------------------------- overload / host KV tier
    def _pick_victim(self, exclude=frozenset()):
        """Choose a preemption victim through the scheduler's policy.

        Decode-live sequences are preferred over mid-prefill ones;
        finished-but-unreleased sequences are never victims (``release``
        is the tool for those).  Returns a RequestState or None."""
        decode, prefill = [], []
        for sid in self._slot_of:
            if sid in exclude:
                continue
            st = self._states.get(sid)
            if st is None or st.done:
                continue
            (prefill if sid in self._prefilling else decode).append(st)
        cands = decode or prefill
        if not cands:
            return None
        vic_fn = getattr(self.scheduler, "victim", None) or default_victim
        return vic_fn(cands, self._step_count)

    def _make_room(self, incoming_st, reserved, need, exclude) -> bool:
        """Preempt policy-approved victims until ``reserved + need`` fits.
        ``should_preempt`` gates every eviction (FIFO/SPF always say no —
        admission waits; priority lets a strictly higher-effective request
        evict), and each preemption removes one candidate."""
        while not self._capacity_ok(reserved, need):
            vic = self._pick_victim(exclude)
            if vic is None:
                return False
            sp = getattr(self.scheduler, "should_preempt", None)
            if sp is None or not sp(incoming_st.request,
                                    incoming_st.arrival, vic,
                                    self._step_count):
                return False
            self.preempt_request(vic.request.seq_id)
        return True

    def _footprint_blocks(self, req) -> int:
        """Whole-request KV footprint in blocks (frontend + prompt + all of
        max_new_tokens, plus one spare block for a speculative window's
        overshoot), clamped to the per-sequence maximum."""
        bs = self.cfg.kv_block_size
        total = (self._front_tokens() + len(np.asarray(req.prompt))
                 + req.max_new_tokens)
        need = (total + bs - 1) // bs + (1 if self.spec_K else 0)
        return min(need, self.spec.max_blocks_per_seq)

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
                                    if self._states[sid].done),
            preempted=len(self._preempted))

    def _attribute_swap(self, counter: np.ndarray,
                        rec: _HostTierSeq) -> None:
        """Charge a swap record's bytes to the KV shards.  A single device
        holds one shard, which takes everything (the split across shards
        by each block's owner is ROADMAP P15)."""
        counter[0] += rec.nbytes

    def preempt_request(self, seq_id: int) -> None:
        """Swap a live sequence out to the host KV tier.

        Safe points only: between steps, or inside ``step()`` before
        admission / after the commit (the injector's "pre"/"post"
        phases), or at an allocation miss after the step's prefill
        dispatches.  Pending slot migrations land first; then ONE gather
        of the sequence's mapped ``k_pool``/``v_pool`` rows and ONE
        device-to-host batch save its KV, its recurrent or cross-attention
        rows and, under speculative decoding, its token-history row.
        Sampling keys need no save.
        The request re-enters the scheduler queue with its ORIGINAL
        arrival step, so aging policies keep its seniority.

        Two states need care (the JAX engine mishandles both): a request
        that registered but has not had a chunk admitted is still queued
        and stays where it is (queueing it twice admitted its prompt
        twice); and a request whose final chunk was dispatched this step
        parks as decode-live, since its whole prompt is installed and its
        first token lands at this step's commit (parking it mid-prefill
        waited forever for a chunk that does not exist)."""
        st = self._states.get(seq_id)
        if st is None or st.done or seq_id not in self._slot_of:
            raise ValueError(f"sequence {seq_id} is not live")
        m = self.manager
        slot = self._slot_of[seq_id]
        # the manager's slot map is post-copy; the pool must be too
        self._apply_copies()
        mapped = [bslot for bslot in (m.lookup(seq_id, b)[0] for b in
                                      range(self.spec.max_blocks_per_seq))
                  if bslot >= 0]
        kv = hist = None
        if mapped:
            idx = _upload(np.asarray(mapped, np.int64), self.device)
            kv = torch.stack([self.dstate["k_pool"][:, idx],
                              self.dstate["v_pool"][:, idx]])
        if self.spec_K:
            hist = self.dstate["hist"][slot]
        names = [k for k in ("ssm", "conv", "cross_k", "cross_v")
                 if k in self.dstate]
        kv, hist, *rows = self._to_host(
            kv, hist, *(self.dstate[k][:, slot] for k in names))
        rows = dict(zip(names, rows))
        saved = m.preempt(seq_id)
        if len(saved) != len(mapped):
            raise RuntimeError("preempt: gathered and released blocks "
                               "differ")
        progress = self._prefilling.get(seq_id)
        if progress == len(st.request.prompt):
            progress = None          # installed; first token in flight
        rec = _HostTierSeq(
            seq_id=seq_id, ctx=int(self._ctx_host[slot]),
            prefill_progress=progress, blocks=saved, kv=kv,
            nbytes=sum(t.nbytes for t in (kv, hist, *rows.values())
                       if t is not None),
            hist=hist, rows=rows)
        # engine-side slot teardown (release() minus the finishing)
        del self._slot_of[seq_id]
        self._clear_slot(slot)
        req = self.requests.pop(seq_id)
        queued = (req is not self._current and seq_id in self._prefilling
                  and any(r is req for r in self.scheduler.pending()))
        self._prefilling.pop(seq_id, None)
        if self._current is req:
            self._current = None
        self._pending_samp = [(s, r) for s, r in self._pending_samp
                              if r.seq_id != seq_id]
        self._preempted[seq_id] = rec
        self._swap_bytes_out += rec.nbytes
        self._attribute_swap(self._shard_swap_out, rec)
        st.preempts += 1
        self._request_preempts += 1
        self._progress_events += 1
        if not queued:
            self.scheduler.add(req, st.arrival)
        self._sync_translation()

    def _resume_preempted(self, req: Request, reserved, busy) -> bool:
        """Bring a preempted sequence back from the host tier: a fresh
        sequence slot and fresh pool slots (capacity-gated against the
        ledger, preempting policy-approved victims if needed), the saved
        KV copied to the card once and scattered into the pool, the
        context restored, sampling re-scattered.  A mid-prefill victim
        becomes the engine-owned chunk request again.  ``busy`` holds the
        sequences with a chunk accepted earlier in this admission round:
        their blocks are reserved but not allocated yet, so they are no
        victims.  Returns False, leaving the request queued, when no
        sequence slot or capacity is available yet."""
        m = self.manager
        sid = req.seq_id
        rec = self._preempted[sid]
        st = self._states[sid]
        if not m._free_seq_slots:
            return False
        if (self._injector is not None
                and self._injector.alloc_unavailable(self._step_count,
                                                     "resume")):
            return False
        trial = m._free_seq_slots[-1]    # the slot register_sequence pops
        vpns = [self.hybrid_cfg.vpn(trial, b) for b, _ in rec.blocks]
        if not self._capacity_ok(reserved, vpns):
            if (self.overload_policy != "preempt"
                    or not self._make_room(st, reserved, vpns,
                                           exclude=busy | {sid})):
                return False
        self.scheduler.pop(req)
        slot = m.register_sequence(sid)
        m.resume(sid, rec.blocks)
        self._apply_copies()        # resume-time evictions land first
        if rec.kv is not None:
            # re-resolve AFTER the copies: a later block's allocation may
            # have evict-migrated an earlier one within this resume, so
            # the scatter targets where each block lives now
            dst = _upload(np.asarray([m.lookup(sid, b)[0]
                                      for b, _ in rec.blocks], np.int64),
                          self.device)
            kv = (rec.kv if self.device.type == "cpu"
                  else rec.kv.to(self.device, non_blocking=True))
            self.dstate["k_pool"][:, dst] = kv[0]
            self.dstate["v_pool"][:, dst] = kv[1]
        if rec.hist is not None:
            self.dstate["hist"][slot] = rec.hist.to(self.device,
                                                    non_blocking=True)
        for key, row in rec.rows.items():
            self.dstate[key][:, slot] = row.to(self.device,
                                               non_blocking=True)
        self.dstate["ctx_len"][slot] = rec.ctx
        self._ctx_host[slot] = rec.ctx
        self._slot_of[sid] = slot
        self.requests[sid] = req
        self._pending_samp.append((slot, req))
        if rec.prefill_progress is not None:
            self._prefilling[sid] = rec.prefill_progress
            self._current = req
        del self._preempted[sid]
        self._swap_bytes_in += rec.nbytes
        self._attribute_swap(self._shard_swap_in, rec)
        st.last_step = self._step_count
        st.resumes += 1
        self._request_resumes += 1
        self._progress_events += 1
        return True

    def _run_forced_preempts(self, targets) -> None:
        """Apply the injector's forced preemptions; ``"auto"`` targets
        resolve through the victim policy, and targets that are not live
        are skipped (a schedule may outlive the sequence it named)."""
        for t in targets:
            if t == "auto" or t is None:
                vic = self._pick_victim()
                sid = None if vic is None else vic.request.seq_id
            else:
                sid = int(t)
            st = self._states.get(sid) if sid is not None else None
            if (st is None or st.done or sid not in self._slot_of
                    or self.hybrid_cfg.mode == "restrictive_only"):
                continue
            self.preempt_request(sid)

    def _ensure_decode_blocks(self, st: RequestState) -> None:
        """Map every block the next decode dispatch writes for ``st``: the
        block of its position when that sits on a block boundary, or
        under speculative decoding every block of the window
        ``[pos, pos + K]`` within the row's range.

        A capacity miss walks the degradation ladder: preempt a
        policy-chosen victim and retry.  Under ``overload_policy="fail"``
        the miss raises ``PoolExhausted`` with occupancy diagnostics.
        ``restrictive_only`` swaps on a set conflict by design (Fig. 9)."""
        bs = self.cfg.kv_block_size
        K = self.spec_K
        nblk = self.spec.max_blocks_per_seq
        pos = int(self._ctx_host[self._slot_of[st.request.seq_id]])
        if K:
            blocks = range(pos // bs, min((pos + K) // bs, nblk - 1) + 1)
        elif pos % bs == 0:
            blocks = (pos // bs,)
        else:
            return
        for b in blocks:
            self._map_decode_block(st, b)

    def _map_decode_block(self, st: RequestState, b: int) -> None:
        """Map block ``b`` of ``st`` for a decode write (a no-op when it is
        mapped), preempting victims on a capacity miss."""
        m = self.manager
        sid = st.request.seq_id
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
        forced = (self._injector is not None
                  and self._injector.alloc_unavailable(self._step_count,
                                                       "decode"))
        while forced or not self._capacity_ok((), (vpn,)):
            forced = False
            if self.overload_policy != "preempt":
                raise PoolExhausted(
                    f"decode step cannot allocate a KV block for sequence "
                    f"{sid}", **self._pool_diag())
            vic = self._pick_victim(exclude={sid})
            if vic is None:
                raise PoolExhausted(
                    f"sequence {sid} cannot hold its own KV blocks and "
                    "nothing is left to preempt", **self._pool_diag())
            self.preempt_request(vic.request.seq_id)
        if seg == SWAP:
            m.swap_in(sid, b)
            st.swap_faults += 1
        else:
            m.allocate_block(sid, b)

    def _install_sampling(self) -> None:
        """Scatter newly registered requests' SamplingParams into the
        per-slot device tensors (admission path only; the steady decode
        step never touches them)."""
        if not self._pending_samp:
            return
        rows = np.asarray([s for s, _ in self._pending_samp], np.int64)
        sp = [r.sampling for _, r in self._pending_samp]
        keys = np.stack([prng_key_data(p, r.seq_id)
                         for p, (_, r) in zip(sp, self._pending_samp)])
        self._pending_samp.clear()
        dev = self.device
        idx = _upload(rows, dev)
        ds = self.dstate
        ds["samp_temp"][idx] = _upload(
            np.asarray([p.temperature for p in sp], np.float32), dev)
        ds["samp_topk"][idx] = _upload(
            np.asarray([p.top_k for p in sp], np.int32), dev)
        ds["samp_topp"][idx] = _upload(
            np.asarray([p.top_p for p in sp], np.float32), dev)
        ds["samp_key"][idx] = _upload(keys.astype(np.int64), dev)

    def _install_hist(self, chunks) -> None:
        """Scatter admitted prompt spans into the drafter's token history
        (one scatter an admission call; decode steps append accepted
        tokens themselves).  ``chunks`` holds (request, start, end, ...)
        records; positions past the history drop.  The vlm frontend's
        positions stay -1: no token matches them."""
        if not self.spec_K or not chunks:
            return
        H = self.dstate["hist"].shape[1]
        front = self._front_tokens()
        idxs, vals = [], []
        for req, start, end, *_ in chunks:
            pos = np.arange(front + start, min(front + end, H),
                            dtype=np.int64)
            idxs.append(self._slot_of[req.seq_id] * H + pos)
            vals.append(np.asarray(req.prompt[start:start + pos.size],
                                   np.int32))
        dev = self.device
        self.dstate["hist"].view(-1)[_upload(np.concatenate(idxs), dev)] = (
            _upload(np.concatenate(vals), dev))

    def _prefill_bucket(self, grp, s_pad: int, front: int):
        """Allocate blocks and run ONE batched prefill dispatch for a
        bucket of same-padded-length chunks (the frontend's ``front``
        positions ahead of each row's prompt)."""
        m = self.manager
        bs = self.cfg.kv_block_size
        B_pad = _next_pow2(len(grp))
        nblk_cache = (front + s_pad) // bs
        tokens = np.zeros((B_pad, s_pad), np.int64)
        slots = -np.ones((B_pad, nblk_cache), np.int32)
        slot_ids = np.full(B_pad, -1, np.int32)
        ctx = np.zeros(B_pad, np.int32)
        last_pos = np.zeros(B_pad, np.int32)
        allocated: List[Tuple[int, int, int]] = []
        frontend = None
        if self.cfg.frontend != "none":
            frontend = np.zeros((B_pad, self.cfg.frontend_tokens,
                                 self.cfg.d_model), np.float32)
        for i, (req, start, end, final) in enumerate(grp):
            prompt = np.asarray(req.prompt)
            tokens[i, :end] = prompt[:end]
            slot_ids[i] = self._slot_of[req.seq_id]
            ctx[i] = end + front
            last_pos[i] = end - 1
            if frontend is not None:
                frontend[i] = req.frontend
            # new cache blocks of this chunk (chunk 0 also covers the
            # frontend's); blocks an earlier chunk mapped install nothing,
            # and an attention-free model has none to allocate
            if not self._n_attn_layers:
                continue
            cb0 = (front + start) // bs if start else 0
            for cb in range(cb0, (front + end) // bs):
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
        batch = {"tokens": _upload(tokens, dev)}
        if self._has_recurrent:
            # per-row real lengths: dt is zeroed past them, so the pow2
            # pad tail is an exact identity transition of the SSM state
            batch["seq_len"] = _upload(ctx - front, dev)
        if frontend is not None:
            batch["frontend"] = _upload(frontend, dev)
        _, self.dstate, pstats = self._prefill_step(
            self.params, self.dstate, batch,
            _upload(slots, dev), _upload(slot_ids, dev), _upload(ctx, dev),
            _upload(last_pos, dev), sample=self._any_sampled(grp))
        return self._bucket_firsts(grp, slot_ids, ctx, pstats)

    @staticmethod
    def _any_sampled(grp) -> bool:
        return any(not req.sampling.is_greedy for req, *_ in grp)

    def _bucket_firsts(self, grp, slot_ids, ctx, pstats):
        """Record the bucket's context lengths; return [(request, first
        token (1,))] for its final chunks."""
        out = []
        for i, (req, start, end, final) in enumerate(grp):
            self._ctx_host[slot_ids[i]] = int(ctx[i])
            if final:
                out.append((req, pstats["next_token"][i:i + 1]))
        return out

    def _prefix_bucket(self, grp, s_pad: int, nblk_buf: int, front: int):
        """ONE batched prefix-KV dispatch for a bucket of same-shaped
        chunks: allocate the chunks' new blocks, then forward ONLY the
        chunk tokens, reading the prefix's installed pool blocks through
        their translated slots."""
        m = self.manager
        bs = self.cfg.kv_block_size
        B_pad = _next_pow2(len(grp))
        tokens = np.zeros((B_pad, s_pad), np.int64)
        new_slots = -np.ones((B_pad, s_pad // bs), np.int32)
        prefix_slots = -np.ones((B_pad, nblk_buf), np.int32)
        slot_ids = np.full(B_pad, -1, np.int32)
        ctx = np.zeros(B_pad, np.int32)
        pctx = np.zeros(B_pad, np.int32)
        last_pos = np.zeros(B_pad, np.int32)
        allocated: List[Tuple[int, int, int, int]] = []
        for i, (req, start, end, final) in enumerate(grp):
            prompt = np.asarray(req.prompt)
            tokens[i, :end - start] = prompt[start:end]
            slot_ids[i] = self._slot_of[req.seq_id]
            ctx[i] = end + front
            pctx[i] = start + front
            last_pos[i] = end - start - 1
            if not self._n_attn_layers:
                continue
            start_blk = (front + start) // bs
            for j, cb in enumerate(range(start_blk, (front + end) // bs)):
                if m.lookup(req.seq_id, cb)[0] >= 0:
                    continue
                info = m.allocate_block(req.seq_id, cb)
                if info.seg == SWAP:
                    raise RuntimeError("pool exhausted during prefill")
                allocated.append((i, j, req.seq_id, cb))
        # allocation-time evictions queue slot migrations: drain them
        # BEFORE reading the prefix slots, and re-resolve the new slots
        # (a later allocation may have evict-migrated an earlier one)
        self._apply_copies()
        for i, j, sid, cb in allocated:
            new_slots[i, j] = m.lookup(sid, cb)[0]
        for i, (req, start, end, final) in enumerate(grp):
            if not self._n_attn_layers:
                break
            for cb in range((front + start) // bs):
                slot, _ = m.lookup(req.seq_id, cb)
                if slot < 0:
                    # a prefix block was evicted to swap: its data is gone
                    # and the prefix-KV read cannot rebuild it
                    raise RuntimeError(
                        "prefix block swapped out during chunked "
                        "prefill; grow the pool or use "
                        "prefill_mode='recompute'")
                prefix_slots[i, cb] = slot
        dev = self.device
        _, self.dstate, pstats = self._prefix_step(
            self.params, self.dstate, {"tokens": _upload(tokens, dev)},
            _upload(new_slots, dev), _upload(prefix_slots, dev),
            _upload(slot_ids, dev), _upload(ctx, dev), _upload(pctx, dev),
            _upload(last_pos, dev), sample=self._any_sampled(grp))
        return self._bucket_firsts(grp, slot_ids, ctx, pstats)

    def _complete_prefill(self, req: Request, nxt: int) -> None:
        self._prefilling.pop(req.seq_id, None)
        st = self._states[req.seq_id]
        st.generated.append(nxt)
        st.new_tokens.append(nxt)
        self._tokens_emitted += 1
        self._maybe_finish(st, nxt)

    def _finish(self, st: RequestState, reason: str) -> None:
        st.done = True
        st.finish_reason = reason
        sid = st.request.seq_id
        if self._preempted.pop(sid, None) is not None:
            # parked while its first token was in flight, and that token
            # finished it: nothing is left to resume
            self.scheduler.remove(st.request)
            self.finished[sid] = st.request
        if self.auto_release and sid in self._slot_of:
            self.release(sid)
        if self.metrics is not None:
            self.metrics.on_finish(sid, self._step_count, len(st.generated),
                                   reason)

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
        only the entries dirtied since the previous sync are written.  A
        model without attention layers has no tables."""
        if not self._n_attn_layers:
            return
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
        if not copies or not self._n_attn_layers:
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
        that produced a token (prefill completions AND decodes).

        With a ``MetricsLogger`` attached (``EngineConfig.metrics``) each
        step also emits one host-side event (wall time on the monotonic
        clock, counter deltas, occupancy gauges) after the commit; the
        logger touches no tensor, so streams are bit-identical logger-on
        and logger-off."""
        if self.metrics is None:
            return self._step_impl()
        t0 = time.perf_counter()
        out = self._step_impl()
        wall = time.perf_counter() - t0
        self.metrics.on_step(self._step_count, wall,
                             self._metrics_counters(),
                             self._metrics_gauges())
        return out

    def _injected(self, phase: str) -> None:
        """The injector's forced preemptions at a safe point, then its
        crash point of the same phase (a scheduled ``InjectedStepFault``
        simulates the process dying there; recovery restores a snapshot,
        never unwinds).  At ``"pre"`` the crash comes first: the step has
        not mutated anything yet."""
        inj = self._injector
        if phase == "pre":
            inj.maybe_crash(self._step_count, "pre")
        self._run_forced_preempts(
            inj.forced_preempts(self._step_count, phase))
        if phase == "post":
            inj.maybe_crash(self._step_count, "post")

    def _step_impl(self) -> Dict[int, int]:
        self._step_count += 1
        if self._injector is not None:
            self._injected("pre")
        pending = self._admit(self.prefill_budget)
        live = [self._states[sid] for sid in self.requests
                if not self._states[sid].done
                and sid not in self._prefilling]
        m = self.manager
        bs = self.cfg.kv_block_size
        nblk = self.spec.max_blocks_per_seq
        B = self.max_batch
        K = self.spec_K
        parts = [tok for _, tok in pending]
        want_stats = False
        if live and self._n_attn_layers:
            # map the blocks this dispatch will write FIRST: an allocation
            # miss may preempt another live sequence (it then drops out of
            # the batch), so tokens/active are built once residency settles
            for st in live:
                if st.request.seq_id in self._slot_of:
                    self._ensure_decode_blocks(st)
            live = [st for st in live if st.request.seq_id in self._slot_of]
        if live:
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
            step_fn = self._spec_step if K else self._serve_step
            _, self.dstate, tstats = step_fn(
                self.params, self.dstate, _upload(tokens, self.device),
                _upload(active, self.device),
                sample=any(not st.request.sampling.is_greedy
                           for st in live))
            if K:
                # each row's K+1 window tokens and its emitted count ride
                # the step's one copy
                parts += [tstats["acc_tokens"].reshape(-1),
                          tstats["n_emit"]]
            else:
                parts.append(tstats["next_token"])
            parts.append(self.dstate["ctx_len"])
            want_stats = self.track_stats and self._n_attn_layers > 0
            if want_stats:
                # in_rest, accesses, mapped: one int32 block, as written
                parts.append(tstats["telemetry"])
        if not parts:
            if self._injector is not None:
                self._injected("post")
            return {}
        # ---- the step's ONE device->host copy ---------------------------
        host = torch.cat(parts).cpu().numpy()
        firsts, host = host[:len(pending)], host[len(pending):]

        out: Dict[int, int] = {}
        if live:
            if K:
                acc_all = host[:B * (K + 1)].reshape(B, K + 1)
                host = host[B * (K + 1):]
            nxt_all, host = host[:B], host[B:]      # (n_emit under spec)
            ctx_all, host = host[:B], host[B:]
            self._ctx_host[:] = ctx_all
            if want_stats:
                in_rest, accesses, mapped = (
                    host[i * B * nblk:(i + 1) * B * nblk].reshape(B, nblk)
                    for i in range(3))
                live_slots = [self._slot_of[st.request.seq_id]
                              for st in live]
                live_mask = np.zeros(B, bool)
                live_mask[live_slots] = True
                # pre-step block counts: blocks covering [0, pos] ([0,
                # pos + K] under speculation, the window the verify
                # reads), masked by the device ``mapped`` flag
                n_pre = np.minimum((ctx_pre + K) // bs + 1, nblk)
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
            if K:
                self._commit_spec(live, acc_all, nxt_all, ctx_pre, out)
            else:
                for st in live:
                    sid = st.request.seq_id
                    nxt = int(nxt_all[self._slot_of[sid]])
                    st.generated.append(nxt)
                    st.new_tokens.append(nxt)
                    st.last_step = self._step_count
                    self._tokens_emitted += 1
                    out[sid] = nxt
                    self._maybe_finish(st, nxt)
        for (r, _), nxt in zip(pending, firsts):
            self._complete_prefill(r, int(nxt))
            out[r.seq_id] = int(nxt)
        if self._injector is not None:
            self._injected("post")
        return out

    def _commit_spec(self, live, acc_all, n_emit_all, ctx_pre, out) -> None:
        """Variable-length commit of the speculative windows.

        The step advanced ``ctx_len`` by ``n_emit`` on the device; the
        host walks each row's emitted tokens in order and stops at eos /
        ``max_new_tokens`` where sequential decode stops.  The capacity
        clamp commits no token from a query position whose K/V write fell
        past the row's last KV block (``nblk * bs``): such a token is not
        exact; at ``cap <= 0`` nothing can be, and the row finishes with a
        ``"length"`` stop.  A row that committed fewer tokens than the
        device advanced is rewound (one upload, no copy back), and the
        blocks a rejected or truncated tail crossed into are freed: all
        but the block of a live row's next write position."""
        m = self.manager
        bs = self.cfg.kv_block_size
        K = self.spec_K
        nblk = self.spec.max_blocks_per_seq
        rewinds: Dict[int, int] = {}
        for st in live:
            sid = st.request.seq_id
            slot = self._slot_of[sid]
            pos = int(ctx_pre[slot])
            cap = nblk * bs - pos
            n_emit = int(n_emit_all[slot])
            n = min(n_emit, cap) if cap > 0 else 0
            committed = 0
            for t in acc_all[slot, :n].tolist():
                st.generated.append(t)
                st.new_tokens.append(t)
                out[sid] = t
                committed += 1
                self._maybe_finish(st, t)
                if st.done:
                    break
            # acceptance counts the drafts that entered the stream (the
            # last committed token is the target's own)
            st.drafted += K
            st.accepted += max(committed - 1, 0)
            st.last_step = self._step_count
            self._tokens_emitted += committed
            self._spec_drafted += K
            self._spec_accepted += max(committed - 1, 0)
            if cap <= 0 and not st.done:
                self._finish(st, "length")
            if sid not in self._slot_of:
                continue        # finished and auto-released: slot reset
            new_ctx = pos + committed
            if committed < n_emit:
                rewinds[slot] = new_ctx
                self._ctx_host[slot] = new_ctx
            # a live row keeps the block of its next write position (the
            # bonus token is fed there next step); a finished row keeps
            # nothing it will not read
            threshold = new_ctx if st.done else new_ctx + 1
            for b in range((threshold + bs - 1) // bs,
                           min((pos + K) // bs, nblk - 1) + 1):
                m.free_block(sid, b)
        if rewinds:
            dev = self.device
            self.dstate["ctx_len"][_upload(
                np.fromiter(rewinds, np.int64, len(rewinds)), dev)] = (
                _upload(np.fromiter(rewinds.values(), np.int32,
                                    len(rewinds)), dev))

    # ---------------------------------------------------- streaming output
    @property
    def step_count(self) -> int:
        return self._step_count

    def poll(self) -> List[RequestOutput]:
        """Cancel requests whose deadline elapsed, advance the engine one
        step (if any work remains) and return a ``RequestOutput`` per
        request that produced tokens or finished since the previous poll.

        Under overload (``overload_policy="preempt"``) a full pool
        preempts victims to the host KV tier and keeps serving.  Raises
        ``PoolExhausted`` when a step makes NO progress (no token, no
        chunk admitted, no preempt/resume, no injected fault) while
        requests are queued: every slot is held by a
        finished-but-unreleased sequence.  (The JAX engine also raises
        after a step whose only event was an injected allocation denial,
        which is transient by definition.)"""
        self._enforce_deadlines()
        if self.has_unfinished():
            before = self._progress_mark()
            out = self.step()
            if (not out and self.waiting
                    and before == self._progress_mark()):
                raise PoolExhausted(
                    f"{len(self.waiting)} queued request(s) cannot be "
                    "admitted and nothing is decoding: release finished "
                    "sequences or construct the engine with "
                    "auto_release=True", **self._pool_diag())
        return self._drain_outputs()

    def _progress_mark(self):
        """What a step that made progress changes (poll's no-progress
        guard): prefill progress, the queue, residency, preempt / resume /
        cancel events, and the injector's log."""
        fired = len(self._injector.log) if self._injector is not None else 0
        return (dict(self._prefilling), len(self.waiting),
                len(self._slot_of), self._progress_events, fired)

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

    # -------------------------------------------- cancellation / deadlines
    def cancel(self, seq_id: int, reason: str = "cancelled") -> bool:
        """Terminate a request wherever it is in its lifecycle — queued,
        mid-chunk prefill, decoding, or parked on the host KV tier — and
        reclaim everything it holds: its sequence slot, KV blocks, prefix
        cache references and ledger claims.

        The final ``RequestOutput`` carries ``finished=True`` with
        ``finish_reason="cancelled"`` (``"deadline"`` from the deadline
        sweep) and the tokens generated before the cut.  Returns False,
        touching nothing, when the id is unknown or already finished.  The
        slot is released even under ``auto_release=False``."""
        st = self._states.get(seq_id)
        if st is None or st.done:
            return False
        req = st.request
        if self._current is req:
            self._current = None
        try:
            # queued (never admitted) or preempted requests sit in the
            # scheduler queue; live decoders do not
            self.scheduler.remove(req)
        except (ValueError, AttributeError):
            pass
        # a host-tier copy dies with the cancel (preempt_request already
        # freed the manager side)
        self._preempted.pop(seq_id, None)
        self._pending_samp = [(s, r) for s, r in self._pending_samp
                              if r.seq_id != seq_id]
        st.done = True
        st.finish_reason = reason
        if reason == "deadline":
            self._deadline_expired += 1
        else:
            self._cancelled += 1
        # a cancel is progress for poll()'s no-progress guard: the freed
        # capacity admits a queued request on the next step
        self._progress_events += 1
        if seq_id in self._slot_of:
            self.release(seq_id)     # frees slot, blocks, pins, ledger
        else:
            rq = self.requests.pop(seq_id, None)
            self.finished[seq_id] = rq if rq is not None else req
            self._prefilling.pop(seq_id, None)
            self._chain_cache.pop(seq_id, None)
        if self.metrics is not None:
            self.metrics.on_finish(seq_id, self._step_count,
                                   len(st.generated), reason)
        return True

    def _enforce_deadlines(self) -> None:
        """Cancel every live request whose wall-clock budget elapsed, with
        ``finish_reason="deadline"`` (one clock read per poll, none when
        no request carries a deadline)."""
        now = None
        for sid in [s for s, st in self._states.items()
                    if not st.done and st.deadline_at is not None]:
            if now is None:
                now = time.perf_counter()
            if now >= self._states[sid].deadline_at:
                self.cancel(sid, reason="deadline")

    # ------------------------------------------------------------ teardown
    def _clear_slot(self, slot: int) -> None:
        """Reset a batch slot's context (and its drafter history: a
        recycled slot must not draft from its predecessor's tokens)."""
        self.dstate["ctx_len"][slot] = 0
        self._ctx_host[slot] = 0
        if self.spec_K:
            self.dstate["hist"][slot] = -1

    def _to_host(self, *tensors):
        """Host copies of device tensors (None passes through): a batch
        of asynchronous copies and one synchronisation."""
        if self.device.type == "cpu":
            return [None if t is None else t.clone() for t in tensors]
        # a non-blocking copy to the host lands in pinned memory
        out = [None if t is None else t.to("cpu", non_blocking=True)
               for t in tensors]
        torch.cuda.current_stream(self.device).synchronize()
        return out

    def release(self, seq_id: int) -> None:
        self.manager.free_sequence(seq_id)
        self._chain_cache.pop(seq_id, None)
        slot = self._slot_of.pop(seq_id)
        self._clear_slot(slot)
        req = self.requests.pop(seq_id, None)
        if req is not None:
            self.finished[seq_id] = req
        if self._current is not None and self._current.seq_id == seq_id:
            self._current = None
        self._prefilling.pop(seq_id, None)
        self._sync_translation()

    # --------------------------------------------------- snapshot / restore
    _SNAP_FIELDS = (
        "requests", "finished", "_states", "_current", "_slot_of",
        "_prefilling", "_pending_samp", "_step_count", "admission_log",
        "_preempted", "_swap_bytes_out", "_swap_bytes_in",
        "_progress_events", "_request_preempts", "_request_resumes",
        "_dropped_preempts", "_dropped_resumes", "_tokens_emitted",
        "_spec_drafted", "_spec_accepted", "_cancelled",
        "_deadline_expired", "_chain_cache",
    )

    def snapshot(self) -> EngineSnapshot:
        """Capture the whole serving state as one value, at a step
        boundary (the safe points of ``preempt_request``).

        Device side: every decode-state tensor except the TAR/SF/flex
        tables (functions of the host tables, re-uploaded on restore),
        copied to the host in one batch of asynchronous copies and one
        synchronisation.  Host side: ONE ``pickle.dumps`` of the manager,
        prefix cache, scheduler queue, request registries and states
        (mid-chunk progress and the host KV tier included) and all
        monotone counters; absolute deadlines become remaining budgets.
        The snapshot stays valid after the engine advances, and restoring
        it on an engine of the same configuration replays
        bit-identically."""
        # pending slot migrations land first, so the pool bytes agree with
        # the manager's (pickled) post-copy slot map
        self._apply_copies()
        keys = [k for k in self.dstate if k not in _TRANSLATION]
        dstate = dict(zip(keys, self._to_host(*(self.dstate[k]
                                                for k in keys))))
        now = time.perf_counter()
        payload: Dict[str, Any] = {f: getattr(self, f)
                                   for f in self._SNAP_FIELDS}
        payload.update(
            manager=self.manager, prefix_cache=self.prefix_cache,
            scheduler=self.scheduler, _ctx_host=self._ctx_host,
            _shard_swap_out=self._shard_swap_out,
            _shard_swap_in=self._shard_swap_in,
            deadline_remaining={
                sid: st.deadline_at - now
                for sid, st in self._states.items()
                if st.deadline_at is not None and not st.done})
        # the scheduler's back-pointer would drag the whole Engine (and
        # its params) into the blob; strip it around the dump
        sched = self.scheduler
        bound = getattr(sched, "_bound_engine", None)
        if bound is not None:
            sched._bound_engine = None
        try:
            blob = pickle.dumps(payload, pickle.HIGHEST_PROTOCOL)
        finally:
            if bound is not None:
                sched._bound_engine = bound
        return EngineSnapshot(version=SNAPSHOT_VERSION,
                              step=self._step_count, dstate=dstate,
                              host_blob=blob)

    def restore(self, snap: EngineSnapshot) -> None:
        """Overwrite this engine's serving state with ``snap``'s.

        The engine must have the configuration the snapshot was taken
        under (the device tensors' names, shapes and dtypes are checked).
        Everything live is discarded: requests submitted after the
        snapshot are gone (``ResilientServe`` journals and resubmits
        them).  The device tensors are written back in place (``copy_``),
        so the pool is never held twice and every tensor a kernel reads
        by pointer stays where it was; the translation tables are
        re-uploaded from the restored host tables."""
        if snap.version != SNAPSHOT_VERSION:
            raise ValueError(
                f"snapshot version {snap.version} != engine "
                f"{SNAPSHOT_VERSION}: cross-version restore unsupported")
        expect = {k: (tuple(v.shape), v.dtype)
                  for k, v in self.dstate.items() if k not in _TRANSLATION}
        got = {k: (tuple(v.shape), v.dtype) for k, v in snap.dstate.items()}
        if got != expect:
            diff = sorted(k for k in set(expect) | set(got)
                          if expect.get(k) != got.get(k))
            raise ValueError("snapshot device state does not match this "
                             f"engine config: {diff} differ")
        host = pickle.loads(snap.host_blob)
        for f in self._SNAP_FIELDS:
            setattr(self, f, host[f])
        self.manager = host["manager"]
        self.prefix_cache = host["prefix_cache"]
        if getattr(self.scheduler, "_bound_engine", None) is self:
            self.scheduler._bound_engine = None
        self.scheduler = host["scheduler"]
        try:
            self.scheduler._bound_engine = self
        except AttributeError:
            pass
        self._ctx_host = np.asarray(host["_ctx_host"], np.int64).copy()
        self._shard_swap_out = np.asarray(host["_shard_swap_out"],
                                          np.int64).copy()
        self._shard_swap_in = np.asarray(host["_shard_swap_in"],
                                         np.int64).copy()
        # deadline budgets restart from the remaining time at snapshot:
        # the crash and restore pause does not count against a request
        now = time.perf_counter()
        for sid, rem in host["deadline_remaining"].items():
            st = self._states.get(sid)
            if st is not None:
                st.deadline_at = now + rem
        for k, v in snap.dstate.items():
            self.dstate[k].copy_(v, non_blocking=True)
        self._synced_full = False
        self._sync_translation(full=True)
        if self.metrics is not None:
            # the logger differentiates ABSOLUTE counters: rebase it so
            # the rewind gives no negative deltas
            self.metrics.rebase(self._metrics_counters())

    # ---------------------------------------------------------- telemetry
    def _kv_block_bytes(self) -> int:
        """Device bytes one pool block occupies across both KV pools (all
        layers): the unit behind ``bytes_saved``; 0 without a pool."""
        if not self._n_attn_layers:
            return 0
        k, v = self.dstate["k_pool"], self.dstate["v_pool"]
        return (k.nbytes + v.nbytes) // k.shape[1]

    def _metrics_counters(self) -> Dict[str, int]:
        """ABSOLUTE monotone counters for the metrics logger (it
        differentiates them into per-step deltas); host reads only, so the
        logger's totals agree with ``stats()`` at every step."""
        m = self.manager
        pc = self.prefix_cache
        return {
            "tokens": self._tokens_emitted,
            "rsw_hits": int(m.stats.get("rsw_hits", 0)),
            "flex_walks": int(m.stats.get("flex_walks", 0)),
            "swap_faults": int(m.stats.get("faults", 0)),
            "spec_drafted": self._spec_drafted,
            "spec_accepted": self._spec_accepted,
            "request_preempts": self._request_preempts,
            "request_resumes": self._request_resumes,
            "swap_bytes_out": self._swap_bytes_out,
            "swap_bytes_in": self._swap_bytes_in,
            "prefix_lookups": int(pc.stats["lookups"]) if pc else 0,
            "prefix_hits": int(pc.stats["hits"]) if pc else 0,
            "cancelled": self._cancelled,
            "deadline_expired": self._deadline_expired,
        }

    def _metrics_gauges(self) -> Dict[str, Any]:
        """Point-in-time gauges copied into the step event verbatim."""
        total = self.hybrid_cfg.total_slots
        mapped = sum(1 for i in self.manager.blocks.values() if i.slot >= 0)
        return {
            "pool_blocks": total,
            "mapped_blocks": mapped,
            "occupancy": mapped / max(total, 1),
            "live": sum(1 for sid in self.requests
                        if not self._states[sid].done),
            "queued": len(self.waiting),
            "host_tier_seqs": len(self._preempted),
        }

    def stats(self) -> dict:
        """Global manager counters; ``spec_drafted`` / ``spec_accepted``
        (speculative decoding: drafts proposed, drafts that entered a
        stream); ``"overload"``: sequence-granularity
        preempt/resume counts (the manager's), host-tier residency, swap
        bytes each way and the monotone per-request preempt/resume
        counters with the share banked on seq_id reuse; ``"lifecycle"``:
        cancels and deadline expiries; ``"prefix_cache"`` (the cache's
        counters as the JAX engine reports them); and ``"per_request"``:
        RestSeg hits / flexible walks / swap faults / drafts proposed and
        accepted / cache-attached blocks / preempts / resumes of each
        seq_id (the ``drafted``, ``accepted`` and ``cached_blocks`` rows sum
        to ``spec_drafted``, ``spec_accepted`` and ``dedup_blocks``)."""
        s = dict(self.manager.stats)
        s["spec_drafted"] = self._spec_drafted
        s["spec_accepted"] = self._spec_accepted
        s["overload"] = {
            "preempted_seqs": int(self.manager.stats.get("preempt_out", 0)),
            "resumed_seqs": int(self.manager.stats.get("preempt_in", 0)),
            "host_tier_seqs": len(self._preempted),
            "swap_bytes_out": self._swap_bytes_out,
            "swap_bytes_in": self._swap_bytes_in,
            "request_preempts": self._request_preempts,
            "request_resumes": self._request_resumes,
            "dropped_request_preempts": self._dropped_preempts,
            "dropped_request_resumes": self._dropped_resumes,
        }
        s["lifecycle"] = {"cancelled": self._cancelled,
                          "deadline_expired": self._deadline_expired}
        pc = self.prefix_cache
        s["prefix_cache"] = {
            "enabled": pc is not None,
            "lookups": int(pc.stats["lookups"]) if pc else 0,
            "hits": int(pc.stats["hits"]) if pc else 0,
            "dedup_blocks": int(pc.stats["dedup_blocks"]) if pc else 0,
            "bytes_saved": (int(pc.stats["dedup_blocks"])
                            * self._kv_block_bytes() if pc else 0),
            "inserts": int(pc.stats["inserts"]) if pc else 0,
            "insert_bypass": int(pc.stats["insert_bypass"]) if pc else 0,
            "evictions": int(pc.stats["evictions"]) if pc else 0,
            "cached_blocks": pc.n_entries if pc else 0,
        }
        s["per_request"] = {
            sid: {"rsw_hits": st.rsw_hits, "flex_walks": st.flex_walks,
                  "swap_faults": st.swap_faults, "drafted": st.drafted,
                  "accepted": st.accepted,
                  "cached_blocks": st.cached_blocks,
                  "preempts": st.preempts, "resumes": st.resumes}
            for sid, st in self._states.items()}
        return s

    def check_invariants(self) -> None:
        """The manager's structural oracle, plus: the prefix cache's
        directory agrees with the manager, the monotone preempt/resume
        counters equal the per-request rows plus the banked share, the
        per-shard swap bytes sum to the global ones, and the device
        translation tables equal the host tables (after uploading the
        deltas a step leaves for the next step's sync)."""
        self._sync_translation()
        self.manager.check_invariants()
        if self.prefix_cache is not None:
            self.prefix_cache.check_invariants()
        assert (sum(st.preempts for st in self._states.values())
                + self._dropped_preempts == self._request_preempts), \
            "per-request preempts + dropped != global request_preempts"
        assert (sum(st.resumes for st in self._states.values())
                + self._dropped_resumes == self._request_resumes), \
            "per-request resumes + dropped != global request_resumes"
        assert int(self._shard_swap_out.sum()) == self._swap_bytes_out, \
            "per-shard swap-out bytes != global"
        assert int(self._shard_swap_in.sum()) == self._swap_bytes_in, \
            "per-shard swap-in bytes != global"
        m = self.manager
        if not self._n_attn_layers:
            return
        tar = self.dstate["tar"][0].cpu().numpy()
        sf = self.dstate["sf"][0].cpu().numpy()
        flex = self.dstate["flex"][0].cpu().numpy()
        assert (tar == m.tar).all(), "device TAR != host TAR"
        assert (sf == m.sf).all(), "device SF != host SF"
        assert (flex == m.flex_table.reshape(-1)).all(), \
            "device flex != host flex"
