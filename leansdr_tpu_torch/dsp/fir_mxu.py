"""Real-tap FIR in VALID mode (the counterpart of
leansdr_tpu/dsp/fir_mxu.py `fir_mxu_valid`).

The JAX package computes this as a banded Toeplitz matmul on the TPU's
matrix unit; here it is one `conv1d` (cross-correlation, so the taps go
in as they are). This stage is plain tensor code in the JAX package
too, not a Pallas kernel.

float32 stays float32: cuDNN would run a float32 convolution in TF32 by
default (about three decimal digits), and that error reaches the
demod's symbol decisions, so `fir_valid` turns TF32 off for cuDNN and
for matmuls before it runs.
"""

import torch
import torch.nn.functional as F


def fir_valid(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """y[r, t] = sum_k taps[k] x[r, t+k], t in [0, n - ntaps + 1).

    x [R, n] float32, taps [ntaps] float32 on x's device. The filter
    history is in-band: callers pass ntaps-1 samples of overlap.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return F.conv1d(x[:, None, :], taps.view(1, 1, -1))[:, 0, :]
