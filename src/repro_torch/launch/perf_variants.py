"""Named perf variants of the dry run: the port of
``repro.launch.perf_variants``.

A variant is a ``(cfg, rules, fwd-overrides)`` transform applied before a
dry-run cell is built (``launch/dryrun.py --perf-variant NAME``).  The 25
names and their transforms are the JAX package's.  Six of them ask
``ShardingRules`` for a field it does not have (``gather_once``,
``shard_activations``) and raise the ``TypeError`` that
``dataclasses.replace`` raises, in the port as in the JAX package:
``gather_once``, ``gather_once_no_zero``, ``gather_once_triangular``,
``nosp_mb8``, ``nosp_mb8_triangular`` and ``nosp_mb16``.
"""
from __future__ import annotations

import dataclasses

# name -> (config fields, rules fields, forward overrides)
_VARIANTS = {
    "baseline": ({}, {}, {}),
    # causal flash: skip above-diagonal KV chunks (halves attn FLOPs)
    "triangular": ({}, {}, {"triangular_schedule": True}),
    # parameters TP-only (no data-axis FSDP)
    "no_zero": ({}, {"zero_params": False}, {}),
    "no_remat": ({"remat": False}, {}, {}),
    "remat": ({"remat": True}, {}, {}),
    "big_chunks": ({}, {}, {"q_chunk": 2048, "kv_chunk": 2048}),
    "small_chunks": ({}, {}, {"q_chunk": 512, "kv_chunk": 512}),
    "triangular_no_zero": ({}, {"zero_params": False},
                           {"triangular_schedule": True}),
    "gather_once": ({}, {"gather_once": True}, {}),
    "gather_once_no_zero": ({}, {"gather_once": True, "zero_params": False},
                            {}),
    "gather_once_triangular": ({}, {"gather_once": True},
                               {"triangular_schedule": True}),
    "kv_int8": ({}, {}, {"_kv_int8": True}),
    "kv_int8_no_zero": ({}, {"zero_params": False}, {"_kv_int8": True}),
    "megatron": ({}, {}, {"_megatron": True}),
    "megatron_triangular": ({}, {}, {"triangular_schedule": True,
                                     "_megatron": True}),
    "nosp_mb8": ({"train_microbatches": 8}, {"shard_activations": False},
                 {}),
    "nosp_mb8_triangular": ({"train_microbatches": 8},
                            {"shard_activations": False},
                            {"triangular_schedule": True}),
    "nosp_mb16": ({"train_microbatches": 16}, {"shard_activations": False},
                  {}),
    "mb1": ({"train_microbatches": 1}, {}, {}),
    "mb2": ({"train_microbatches": 2}, {}, {}),
    "mb1_triangular": ({"train_microbatches": 1}, {},
                       {"triangular_schedule": True}),
    "mb8": ({"train_microbatches": 8}, {}, {}),
    "mb16": ({"train_microbatches": 16}, {}, {}),
    "capacity_1": ({"moe_capacity_factor": 1.0}, {}, {}),
    "capacity_2": ({"moe_capacity_factor": 2.0}, {}, {}),
}

NAMES = tuple(_VARIANTS)


def apply(name: str, cfg, rules, shape, multi_pod: bool):
    """Returns ``(cfg, rules, fwd_overrides dict)``: the config replaced
    first, then the rules (the JAX package's order, so a variant that
    raises for its rules raises after its config would have changed)."""
    try:
        c, r, fwd = _VARIANTS[name]
    except KeyError:
        raise ValueError(f"unknown perf variant {name!r}") from None
    if c:
        cfg = dataclasses.replace(cfg, **c)
    if r:
        rules = dataclasses.replace(rules, **r)
    return cfg, rules, dict(fwd)
