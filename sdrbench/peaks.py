"""The card's peaks and the work each measured kernel needs, counted
from its launch shapes by what the algorithm needs, whatever implements
it.

Peaks (NVIDIA H100 SXM data sheet, dense, at its 700 W limit): HBM3 at
3.35e12 bytes/s; 67e12 float32 operations/s outside the tensor cores.
The INT32 issue rate is not published: it is derived as the number of
SMs x 64 INT32 lanes per SM x the SM clock the run reads (132 x 64 x
1.98e9 = 16.7e12 on the card these cells were set on). A roofline share
is the least time (bytes over the bandwidth or operations over their
rate, the larger) over the kernel's device time.
"""

import subprocess

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT32_LANES_PER_SM = 64

# The demod, per input sample of a lane: it reads the sample (I and Q,
# float32) and writes one packed int32 (cost, symbol, valid).
DEMOD_BYTES_PER_SAMPLE = 8 + 4
# Its float32 arithmetic per sample (reference.demod, sincos not counted):
# the second rotation 6, two derotations 12, the interpolation 7, the AGC
# 2, the s8 quantiser 4, the QPSK distances 10, the cost 3, the
# polynomial atan2 20, the phase error 3, the PLL 4, Mueller & Muller 16,
# the counters 2.
DEMOD_FLOPS_PER_SAMPLE = 6 + 12 + 7 + 2 + 4 + 10 + 3 + 20 + 3 + 4 + 16 + 2

# The rate-1/2 ACS, per trellis step (block) of a lane (a carrier's sync
# replica): it reads the step's coded symbol and cost (two int32) and
# writes the survivor bit word and the discriminant (two int32); per
# state two branch additions, a comparison, the select of the metric and
# of the path word and the path's shift-in (6 integer operations), and
# the best state's 63-way minimum.
ACS_BYTES_PER_STEP = 16
ACS_INT_OPS_PER_STEP = 64 * 6 + 63


def card_info() -> dict:
    """The card's name, SM count, maximum SM clock (Hz) and power limit
    (W), from torch and nvidia-smi."""
    import torch
    props = torch.cuda.get_device_properties(0)
    info = dict(name=torch.cuda.get_device_name(0),
                sms=props.multi_processor_count, clock_hz=None,
                power_limit_w=None)
    try:
        q = subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm,power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30)
        clock, power = (v.strip() for v in q.stdout.split(",")[:2])
        info["clock_hz"] = float(clock) * 1e6
        info["power_limit_w"] = float(power)
    except (OSError, ValueError, subprocess.TimeoutExpired):
        pass
    return info


def int32_ops_per_s(info: dict):
    if not info.get("clock_hz"):
        return None
    return info["sms"] * INT32_LANES_PER_SM * info["clock_hz"]


def demod_bound_s(lane_samples: int) -> float:
    return max(lane_samples * DEMOD_BYTES_PER_SAMPLE / HBM_BYTES_PER_S,
               lane_samples * DEMOD_FLOPS_PER_SAMPLE / FP32_OPS_PER_S)


def acs_bound_s(lane_steps: int, int32_rate: float) -> float:
    return max(lane_steps * ACS_BYTES_PER_STEP / HBM_BYTES_PER_S,
               lane_steps * ACS_INT_OPS_PER_STEP / int32_rate)
