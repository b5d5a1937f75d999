"""Plain torch versions of the rows-invariant GEMM kernel: the ops the
port's forward runs without ``rows_invariant`` (``layers.linear``'s
``x @ w`` and ``+ b``, the MoE experts' ``torch.bmm``, the SSD's
``torch.einsum``)."""
import torch
import torch.nn.functional as F


def rows_gemm_ref(x, w, b=None, block=None):
    """``x @ w (+ b)``; with ``block`` one block of that many rows at a
    time (the mamba prefill's narrow dt projection: BLAS libraries split
    a narrow product's reduction by its row count, MKL at 8 threads does,
    so a row would round otherwise in another bucket shape; at one block
    shape a row's bits do not depend on the rows around it)."""
    if block is None:
        y = x @ w
    else:
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        n = x2.shape[0]
        x2 = F.pad(x2, (0, 0, 0, (-n) % block))
        y = torch.cat([blk @ w for blk in x2.split(block)])
        y = y[:n].reshape(*lead, w.shape[-1])
    if b is not None:
        y = y + b
    return y


def rows_bmm_ref(x, w):
    return torch.bmm(x, w)


def rows_einsum_ref(eq: str, a, b):
    return torch.einsum(eq, a, b)
