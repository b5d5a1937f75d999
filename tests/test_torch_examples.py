"""The port's examples (``examples/*_torch.py``) on the CPU, each through its
``main(argv)``, which returns what it printed.

* ``quickstart_torch.py`` prints the JAX ``quickstart.py``'s translation
  statistics exactly (the JAX example runs in this process).
* ``serve_engine_torch.py`` serves the same streams with prefix sharing
  on and off, and with sharing on the prefix cache hits.
* ``train_lm_torch.py`` (reduced, 12 steps): the loss falls, and the run
  with a failure injected at step 6 (restored from step 4's checkpoint,
  steps replayed) ends with the weights and loss of the run without one,
  bitwise.
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import re
from pathlib import Path

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_matches_jax_exactly():
    got = _load("quickstart_torch").main(["--device", "cpu"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _load("quickstart").main()
    assert got.splitlines() == buf.getvalue().strip().splitlines()
    assert "RSW hits: " in got and got.endswith("invariants OK")


def _streams(out: str):
    return [line for line in out.splitlines()
            if re.match(r"  seq \d+: \[", line)]


def test_serve_example_streams_equal_with_and_without_prefix_sharing():
    mod = _load("serve_engine_torch")
    on = mod.main(["--device", "cpu"])
    off = mod.main(["--device", "cpu", "--no-prefix-sharing"])
    assert len(_streams(on)) == 5
    assert _streams(on) == _streams(off)
    hits = int(re.search(r"prefix cache: lookups=\d+ hits=(\d+)",
                         on).group(1))
    assert hits > 0
    assert "hits=0 " in off and on.endswith("invariants OK")


def test_train_example_loss_falls_and_resume_is_bitwise():
    mod = _load("train_lm_torch")
    argv = ["--device", "cpu", "--reduced", "--steps", "12",
            "--ckpt-every", "4"]
    failed = mod.main(argv + ["--fail-at", "6"])
    clean = mod.main(argv + ["--fail-at", "-1"])
    assert "(1 restart)" in failed and "(0 restart)" in clean

    def tail(out):
        return [line for line in out.splitlines()
                if line.startswith("final ")]

    assert len(tail(clean)) == 2 and tail(failed) == tail(clean)
    first, last = (float(x) for x in re.search(
        r"loss ([\d.]+) -> ([\d.]+)", clean).groups())
    assert last < first
