"""Dry run of the port: every (arch x shape x mesh) cell on the ``meta``
device.  The port of ``repro.launch.dryrun``.

For each cell this builds the port's real step (the mesh train step with
the production shardings, the token-split recompute prefill, the
token-split decode step), runs it for ONE rank of the production mesh
(``launch.mesh.make_production_mesh``: a ``MeshDesc``, no process group,
no card) on ``meta`` tensors, so nothing is allocated, and records per
rank:

  * argument bytes: the tensors the step takes, each storage once (the
    state's blocks by the specs, the batch; serving's parameters as the
    rank's blocks under JAX's ``param_shardings``, ZeRO over the data axes
    as ``cfg.zero_shard_params`` or the perf variant sets it, which the
    token-split steps compute with);
  * peak bytes: the arguments plus the largest sum of live tensors the
    step made (``LiveBytes`` follows each meta storage's lifetime);
  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the aten ops
    plus each CUDA kernel's own operation count (the formulas behind
    PERF.md's bounds), which its wrapper records on ``meta`` tensors
    (``kernels._build.META_COSTS``);
  * bytes: every aten op's inputs and outputs, plus each kernel's bytes
    (no fusion: an upper bound on what the card moves);
  * collective bytes by kind, from the mesh description's ``traffic``;
  * the roofline terms against the H100 SXM datasheet's peaks (989 TFLOP/s
    dense bf16, 3.35 TB/s HBM3, 450 GB/s NVLink each way) — datasheet
    figures, not measurements.

XLA's HLO and its cost and memory analyses have no counterpart here:
``--save-hlo`` is accepted and refused with that reason.  The numbers are
not comparable with the JAX dry run's.

Results go to ``build/dryrun/<arch>__<shape>__<mesh>.json`` at the root of
the checkout, or under ``--out``:

  python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh pod|multipod|both] [-j N]
  python -m repro_torch.launch.dryrun --list
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
RESULTS_DIR = os.path.join(ROOT, "build", "dryrun")

# H100 SXM datasheet peaks (not measurements)
PEAK_FLOPS = 989e12          # dense bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12    # HBM3
LINK_BYTES_PER_S = 450e9     # NVLink, each way


def _cell_list():
    from repro_torch.configs import ARCHS, SHAPES, cell_applicable
    cells = []
    for arch in sorted(ARCHS):
        for shape in SHAPES:
            ok, why = cell_applicable(ARCHS[arch], shape)
            cells.append((arch, shape.name, ok, why))
    return cells


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def storage_bytes(tree) -> int:
    """Bytes of the storages of the tensors in ``tree``, each once."""
    seen = {}
    for t in _tensors(tree):
        s = t.untyped_storage()
        seen[s._cdata] = s.nbytes()
    return sum(seen.values())


class LiveBytes(TorchDispatchMode):
    """Follows the storages that the ops under it make: ``peak`` is the
    largest sum of their bytes alive at once (a storage lives while a
    tensor on it does), ``accessed`` the bytes of every op's tensor inputs
    and outputs.  Storages made before (the arguments) are not counted."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = self.accessed = 0
        self._refs = {}

    def _drop(self, key):
        ref = self._refs[key]
        ref[0] -= 1
        if ref[0] == 0:
            self.live -= ref[1]
            del self._refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        inputs = {}
        for t in _tensors((args, kwargs)):
            self.accessed += t.numel() * t.element_size()
            inputs[t.untyped_storage()._cdata] = True
        for t in _tensors(out):
            self.accessed += t.numel() * t.element_size()
            s = t.untyped_storage()
            key = s._cdata
            ref = self._refs.get(key)
            if ref is None:
                if key in inputs:          # a view of an argument
                    continue
                ref = self._refs[key] = [0, s.nbytes()]
                self.live += ref[1]
                self.peak = max(self.peak, self.live)
            ref[0] += 1
            weakref.finalize(t, self._drop, key)
        return out


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               perf_variant: str = "baseline"):
    """Returns ``(run, args, mesh, meta)`` for one cell: ``run()`` runs the
    step once for rank 0 on ``args`` (meta tensors; every rank's shapes
    are the same)."""
    from repro_torch.configs import cell_applicable, get_config, shape_cell
    from repro_torch.dist.sharding import ShardingRules, shard_tree
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import perf_variants
    from repro_torch.models import FwdOptions, model_dims
    from repro_torch.params import init_params
    from repro_torch.serve.decode import (abstract_decode_state,
                                          local_decode_state,
                                          make_decode_spec, make_serve_step,
                                          token_split_tp)
    from repro_torch.serve.prefill import make_prefill_step
    from repro_torch.train import (TrainConfig, abstract_state,
                                   make_train_step, state_shardings)

    cfg = get_config(arch)
    shape = shape_cell(shape_name)
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        raise SystemExit(f"SKIP: {why}")
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
    da = mesh_mod.data_axes_for(mesh)
    tp = mesh.axis("model").size
    G = mesh.axis(da).size
    dims = model_dims(cfg, tp=tp)
    rules = ShardingRules(data_axes=da, zero_params=cfg.zero_shard_params)
    cfg, rules, fwd_over = perf_variants.apply(perf_variant, cfg, rules,
                                               shape, multi_pod)
    B, S = shape.global_batch, shape.seq_len
    dtype = torch.bfloat16
    meta = dict(device="meta")
    mesh_name = "x".join(str(n) for n in mesh.shape.values())
    info = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "kind": shape.kind, "tp": tp, "data_shards": G,
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "perf_variant": perf_variant}

    def batch_of(with_labels: bool):
        b = {"tokens": torch.empty((B, S), dtype=torch.int32, **meta)}
        if with_labels:
            b["labels"] = torch.empty((B, S), dtype=torch.int32, **meta)
        if cfg.frontend != "none":
            b["frontend"] = torch.empty((B, cfg.frontend_tokens,
                                         cfg.d_model), dtype=dtype, **meta)
        return b

    if shape.kind == "train":
        use_megatron = fwd_over.pop("_megatron", False)
        fwd = FwdOptions(attn_impl="flash_jax", dtype=dtype, remat=cfg.remat,
                         q_chunk=1024, kv_chunk=1024, moe_groups=G,
                         **fwd_over)
        tc = TrainConfig(dtype=dtype, grad_compression=multi_pod,
                         microbatches=cfg.train_microbatches,
                         accum_dtype=(torch.bfloat16
                                      if cfg.optimizer == "adafactor"
                                      else torch.float32))
        state_abs = abstract_state(cfg, dims, tc, param_dtype=dtype)
        specs = state_shardings(state_abs, mesh, rules)
        loss_override = None
        if use_megatron:
            if cfg.family != "dense":
                raise SystemExit("SKIP: megatron variant is dense-only")
            from repro_torch.dist.megatron import (make_megatron_forward,
                                                   megatron_loss,
                                                   megatron_param_shardings)
            mfwd = make_megatron_forward(
                cfg, dims, mesh, da, attn_impl="flash_jax",
                triangular=fwd.triangular_schedule, remat=cfg.remat)
            loss_override = megatron_loss(mfwd, mesh)
            p_sh = megatron_param_shardings(state_abs["params"], mesh, rules)
            specs["params"] = p_sh
            if "m" in specs.get("opt", {}):
                specs["opt"] = {"m": p_sh, "v": p_sh}
            if "ef" in specs:
                # the residuals lie as the gradients' blocks do (JAX's
                # GSPMD reshards them; a rank here holds them as they lie)
                from repro_torch.ckpt.checkpoint import (tree_flatten,
                                                        tree_unflatten)
                from repro_torch.dist.compression import EFState
                specs["ef"] = tree_unflatten(p_sh, [
                    EFState(residual=x) for x in tree_flatten(p_sh)[0]])
        state = shard_tree(state_abs, specs, mesh)
        step = make_train_step(cfg, dims, tc, fwd, mesh, rules,
                               loss_override=loss_override, specs=specs)
        batch = batch_of(True)
        return (lambda: step(state, batch)), (state, batch), mesh, info

    # ---- inference cells: the token-split layout over the mesh ----------
    mode = "striped" if shape_name == "long_500k" else "batch"
    seq_eff = S + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    spec = make_decode_spec(cfg, seq_eff, B, G, mode=mode, data_axes=da)
    dstate = local_decode_state(
        abstract_decode_state(cfg, dims, spec, B, G, dtype), spec, mesh)
    params = token_split_tp(cfg, dims, spec, mesh, rules).blocks(
        init_params(None, cfg, dims, dtype=dtype, device="meta"))
    info["mode"] = mode
    if shape.kind == "prefill":
        # the rank forwards its data group's rows as one MoE group
        fwd = FwdOptions(attn_impl="flash_jax", dtype=dtype, remat=False,
                         q_chunk=1024, kv_chunk=1024, **fwd_over)
        step = make_prefill_step(cfg, dims, spec, fwd, mesh=mesh,
                                 rules=rules)
        batch = batch_of(False)
        nblk = seq_eff // spec.block_size
        slots = torch.empty((B, nblk), dtype=torch.int32, **meta)
        row = torch.empty((B,), dtype=torch.int32, **meta)
        args = (params, dstate, batch, slots, row, row, row)
        return (lambda: step(*args)), args, mesh, info
    if shape.kind == "decode":
        if fwd_over.pop("_kv_int8", False):
            # an int8 KV pool (a quantized cache): the decode memory term
            # halves; the dequantization scale is left out of the shapes
            for k in ("k_pool", "v_pool"):
                if k in dstate:
                    dstate[k] = torch.empty(dstate[k].shape,
                                            dtype=torch.int8, **meta)
        step = make_serve_step(cfg, dims, spec, dtype, mesh=mesh,
                               rules=rules)
        tokens = torch.empty((B,), dtype=torch.int32, **meta)
        args = (params, dstate, tokens)
        return (lambda: step(*args)), args, mesh, info
    raise ValueError(shape.kind)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             perf_variant: str = "baseline", save_hlo: bool = False) -> dict:
    if save_hlo:
        raise SystemExit("--save-hlo: the port has no XLA HLO to save (it "
                         "runs eager PyTorch and CUDA kernels)")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    fn, args, mesh, info = build_cell(arch, shape_name, multi_pod,
                                      perf_variant)
    t_build = time.perf_counter() - t0
    _build.META_COSTS.clear()
    mesh.traffic.clear()
    arg_bytes = storage_bytes(args)
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        with LiveBytes() as live:
            fn()
    t_run = time.perf_counter() - t0
    kernels = {k: dict(v) for k, v in _build.META_COSTS.items()}
    k_flops = sum(v["flops"] for v in kernels.values())
    k_bytes = sum(v["bytes"] for v in kernels.values())
    flops = fc.get_total_flops() + k_flops
    nbytes = live.accessed + k_bytes
    coll = dict(mesh.traffic)
    coll_bytes = sum(coll.values())
    result = dict(info)
    result.update({
        "ok": True,
        "build_s": round(t_build, 2),
        "run_s": round(t_run, 2),
        "flops_per_device": float(flops),
        "flops_aten": float(fc.get_total_flops()),
        "bytes_per_device": float(nbytes),
        "kernels": kernels,
        "memory": {"argument_bytes": arg_bytes,
                   "temp_peak_bytes": live.peak,
                   "peak_bytes": arg_bytes + live.peak},
        "collectives": {"bytes_by_kind": coll,
                        "collective_bytes_per_device": coll_bytes},
        "roofline_datasheet_h100_sxm": {
            "compute_s": flops / PEAK_FLOPS,
            "memory_s": nbytes / HBM_BYTES_PER_S,
            "collective_s": coll_bytes / LINK_BYTES_PER_S,
            "peaks": "989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 450 GB/s "
                     "NVLink each way (datasheet)"},
    })
    return result


def _tag(arch, shape, mesh_name, variant="baseline"):
    return (f"{arch}__{shape}__{mesh_name}"
            + ("" if variant == "baseline" else f"__{variant}"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--perf-variant", default="baseline")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--save-hlo", action="store_true",
                    help="refused: the port has no XLA HLO")
    ap.add_argument("--out", default=RESULTS_DIR,
                    help="results directory (default build/dryrun/)")
    ap.add_argument("-j", type=int, default=2, help="parallel cells (--all)")
    args = ap.parse_args(argv)

    if args.list:
        for arch, shape, ok, why in _cell_list():
            print(f"{'RUN ' if ok else 'SKIP'} {arch:26s} {shape:12s} {why}")
        return
    if args.save_hlo:
        raise SystemExit("--save-hlo: the port has no XLA HLO to save (it "
                         "runs eager PyTorch and CUDA kernels)")
    os.makedirs(args.out, exist_ok=True)
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]

    if args.all:
        jobs, failed = [], []
        for arch, shape, ok, why in _cell_list():
            for mp in meshes:
                tag = _tag(arch, shape, "2x16x16" if mp else "16x16")
                out = os.path.join(args.out, tag + ".json")
                if not ok:
                    with open(out, "w") as f:
                        json.dump({"arch": arch, "shape": shape,
                                   "mesh": "2x16x16" if mp else "16x16",
                                   "ok": True, "skipped": True,
                                   "skip_reason": why}, f, indent=1)
                    print(f"SKIP {tag}: {why}")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--out", args.out,
                       "--mesh", "multipod" if mp else "pod"]
                jobs.append((tag, cmd, out))
        running = []
        # run from src/ without PYTHONPATH: src/sitecustomize.py imports JAX
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        while jobs or running:
            while jobs and len(running) < args.j:
                tag, cmd, out = jobs.pop(0)
                p = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True,
                                     cwd=os.path.join(ROOT, "src"))
                running.append((tag, p, out, time.perf_counter()))
            tag, p, out, t0 = running.pop(0)
            log, _ = p.communicate()
            dt = time.perf_counter() - t0
            if p.returncode == 0 and os.path.exists(out):
                print(f"PASS {tag} ({dt:.0f}s)")
            else:
                failed.append(tag)
                with open(out.replace(".json", ".log"), "w") as f:
                    f.write(log)
                print(f"FAIL {tag} ({dt:.0f}s) — see "
                      f"{out.replace('.json', '.log')}")
        print(f"\n{'ALL CELLS PASS' if not failed else 'FAILED: ' + str(failed)}")
        sys.exit(1 if failed else 0)

    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required (or --all / --list)")
    for mp in meshes:
        result = run_cell(args.arch, args.shape, mp,
                          perf_variant=args.perf_variant)
        tag = _tag(args.arch, args.shape, result["mesh"], args.perf_variant)
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(result, f, indent=1)
        mb = result["memory"]
        print(f"{tag}: build {result['build_s']}s run {result['run_s']}s | "
              f"args {mb['argument_bytes'] / 2**30:.2f} GiB peak "
              f"{mb['peak_bytes'] / 2**30:.2f} GiB | flops/dev "
              f"{result['flops_per_device']:.3e} | coll "
              f"{result['collectives']['collective_bytes_per_device'] / 2**30:.3f}"
              " GiB")


if __name__ == "__main__":
    main()
