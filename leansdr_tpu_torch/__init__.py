"""leansdr_tpu_torch — the DVB-S fleet receiver and the single-carrier
receiver with its CLI leandvb in PyTorch, with hand-written CUDA kernels
for an NVIDIA H100 (sm_90a), and the host apps around them.

A port of `leansdr_tpu` (JAX + Pallas for the TPU), which stays beside it
as the reference the port is tested against. This package imports
`torch` and `numpy` only: whatever it needs from `leansdr_tpu`'s pure
NumPy modules it keeps as its own copy.

Layout mirrors `leansdr_tpu`, so each module's counterpart has the same
name:

  device.py  device selection (CUDA by default, never a silent CPU
             fallback) and the nvcc build of the kernels in csrc/
  csrc/      CUDA C++ kernels: demod.cu (carrier PLL + M&M timing + soft
             demap), scan_demod.cu (the same loop with the nearest,
             linear or polyphase rrc sampler and exact-LUT or computed
             decisions), hs_demod.cu (the integer --hs receiver),
             acs.cu (rate-1/2 Viterbi add-compare-select),
             acs_banked.cu (the ACS of every other rate and
             constellation, B = 1 to 7), fir.cu (causal FIR
             with runtime complex or real taps), fft4096.cu
  dsp/       constellations, filter design, matched filter, the demod
             kernel's wrapper, the FIR kernel's wrapper and the streaming
             --resample filter, the device auto-notch, CNR estimator,
             spectrum and tracking FIR, host blocks
  fec/       convolutional code tables, the algebraic deconvolver, the
             symbol ring, the Viterbi decoders around the ACS kernels,
             RS/PRBS/interleaver
  proto/     MPEG-TS sync and framing; hdlc.py, the HDLC deframer and
             the ETR192 (de)scrambler of --hdlc
  native/    the C++ host byte backend of the fleet (MPEG framing,
             deinterleave, RS decode, derandomize), loaded with ctypes
  core/      generic host blocks (the VBER rate estimator)
  util/      wire sample formats and the --fd-info/--fd-const/
             --fd-spectrum writers;
             ad936x.py (AD936x rate planning and FIR text) and pmp.py
             (PMP buffer descriptors) for leaniio
  pipelines/ the multi-carrier receiver `multi_rx.MultiDvbsReceiver`, the
             single-carrier `dvbs_rx.DvbsReceiver` and RxConfig, the
             TS generator tsgen, the modulator dvbs_tx (batch `modulate`
             and streaming `TxStream`) and the channel simulator chansim
             (drand48 AWGN, LO drift; also --awgn)
  apps/      leandvb, the single-carrier CLI, and leandvbfleet; the host
             apps leantsgen, leandvbtx, leanchansim, leansdrcat,
             leansdrserv, leandvb_tui and leaniio (host NumPy; they
             need no card)
  convert.py carries a `leansdr_tpu` receiver checkpoint into the port
"""

__version__ = "0.1.0"
