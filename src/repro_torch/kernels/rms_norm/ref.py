"""Plain torch versions of the rows-invariant RMS-norm kernel: the
port's ``layers._rms_norm_fwd`` and the gated norm's forward."""
from repro_torch.models import layers as L


def rms_norm_ref(x, scale, eps: float):
    return L._rms_norm_fwd(x, scale, eps)


def gated_rms_norm_ref(y, z, scale, eps: float):
    return (L._rms_norm_fwd(y, scale, eps) * L.silu(z).to(y.dtype)).to(
        y.dtype)
