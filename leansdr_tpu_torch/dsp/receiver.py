"""Constellation receiver parameters and initial loop state (the
counterparts of leansdr_tpu/dsp/receiver.py:29-119).

The per-sample recurrence itself (carrier PLL + Mueller&Muller timing +
soft demap, reference sdr.h:697-938) runs in the demod kernel
(dsp/receiver_kernel.py); this module holds its static configuration and
the cold-start state. Constants match Appendix A of SURVEY.md:
freq_alpha=0.04, freq_beta=0.0012/omega*pll_adjustment,
gain_mu=0.02/cstln_amp^2*2, max_mucorr=0.1, kest=0.01, angle convention
65536=2pi.
"""

from dataclasses import dataclass

import torch

from .cstln import CSTLN_AMP

CHUNK = 128      # samples between AGC/MER/clamp updates (sdr.h:706)


@dataclass(frozen=True)
class ReceiverParams:
    """Static configuration of the demod loop."""
    omega: float                 # samples per symbol
    sampler: str = "linear"      # "nearest" | "linear" | "rrc"
    pll_adjustment: float = 1.0
    allow_drift: bool = False
    kest: float = 0.01
    meas_decimation: int = 1 << 20
    nsymbols: int = 4            # for BPSK MER special case + freq limits
    freq0: float = 0.0           # initial freq offset, cycles/sample
    rrc_coeffs: tuple = ()       # fir_sampler taps (sdr.h:635-689)
    rrc_steps: int = 1
    # True = the reference's 256x256 LUT + trig16 table decision path;
    # False = the computed path the demod kernel implements.
    exact_lut: bool = True
    omega_per_channel: bool = False

    @property
    def readahead(self) -> int:
        if self.sampler == "nearest":
            return 0
        if self.sampler == "linear":
            return 1
        return (len(self.rrc_coeffs) - 1) // self.rrc_steps + 1

    @property
    def freq_limits(self) -> tuple:
        # update_freq_limits (sdr.h:755-770)
        n = {2: 2, 4: 4, 8: 8, 16: 12, 32: 16}.get(self.nsymbols, 4)
        freqw0 = self.freq0 * 65536
        half = 65536 / self.omega / n / 2
        return (freqw0 - half, freqw0 + half)


def init_state(params: ReceiverParams, nchan: int, device) -> dict:
    """Initial per-channel loop state (mirrors sdr.h:724-736) as float32
    tensors on `device`."""
    if params.omega_per_channel:
        raise NotImplementedError(
            "per-channel omega (the candidate scan) is ROADMAP queue 1 "
            "item 14")
    if params.sampler == "rrc":
        raise NotImplementedError(
            "the polyphase rrc fir_sampler inside the loop is ROADMAP "
            "queue 1 item 10; the fleet uses the matched filter plus the "
            "linear sampler")
    C = nchan
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "mu": torch.zeros(C, **f32),
        "phase": torch.zeros(C, **f32),
        "freqw": torch.full((C,), params.freq0 * 65536, **f32),
        "hist_p": torch.zeros((C, 3, 2), **f32),
        "hist_c": torch.zeros((C, 3, 2), **f32),
        "est_insp": torch.full((C,), CSTLN_AMP * CSTLN_AMP, **f32),
        "agc_gain": torch.ones(C, **f32),
        "est_sp": torch.zeros(C, **f32),
        "est_ep": torch.zeros(C, **f32),
        "meas_count": torch.zeros(C, dtype=torch.int32, device=device),
    }
