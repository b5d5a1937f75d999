"""PyTorch/CUDA port of the Utopia serving stack (``repro``'s counterpart).

Imports ``torch`` and never ``jax`` nor ``repro``.  Layout mirrors
``src/repro/``: ``configs``, ``core``, ``models``, ``kernels/<name>/``
(``ops.py`` wrapper, ``ref.py`` plain torch version, ``csrc/*.cu`` the
hand-written Hopper kernel) and ``serve``.  It runs all six model
families of the JAX package (dense, moe, vlm, audio, ssm, hybrid;
``configs.ARCHS``).  Entry points take an explicit ``device`` (default
``"cuda"``); the tests pass ``"cpu"``.

float32 stays float32: TF32 is switched off for matmuls and cuDNN when the
package is imported, so the card and the CPU compute the same function.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
