"""leansdr_tpu_torch — the DVB-S fleet receiver in PyTorch, with
hand-written CUDA kernels for an NVIDIA H100 (sm_90a).

A port of `leansdr_tpu` (JAX + Pallas for the TPU), which stays beside it
as the reference the port is tested against. This package imports
`torch` and `numpy` only: whatever it needs from `leansdr_tpu`'s pure
NumPy modules it keeps as its own copy.

Layout mirrors `leansdr_tpu`, so each module's counterpart has the same
name:

  device.py  device selection (CUDA by default, never a silent CPU
             fallback) and the nvcc build of the kernels in csrc/
  csrc/      CUDA C++ kernels: demod.cu (carrier PLL + M&M timing + soft
             demap), acs.cu (rate-1/2 Viterbi add-compare-select)
  dsp/       constellations, filter design, matched filter, the demod
             kernel's wrapper and its plain PyTorch version
  fec/       convolutional code tables, the symbol ring, the fleet
             Viterbi around the ACS kernel, TX-side RS/PRBS/interleaver
  native/    the C++ host byte backend (MPEG framing, deinterleave,
             RS decode, derandomize), loaded with ctypes
  pipelines/ the multi-carrier receiver `multi_rx.MultiDvbsReceiver`,
             RxConfig, and the stimulus generators tsgen / dvbs_tx
  convert.py carries a `leansdr_tpu` receiver checkpoint into the port
"""

__version__ = "0.1.0"
