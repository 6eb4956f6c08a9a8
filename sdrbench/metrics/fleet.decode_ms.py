"""Decoder (fec/viterbi_device.viterbi_decode: block inputs, the ACS
kernel, election, packing): device ms per chunk, from the profiler: the
operations launched under the decoder's scope, and the ACS kernel by its
name (the decoder launches it through ctypes, outside any torch
operation, so the profiler links it to no host operation)."""
from sdrbench.metrics._common import kernel_seconds, scope_ms_per_input


def read(data):
    own = scope_ms_per_input(data, "decode", exclude="acs_kernel")
    acs = kernel_seconds(data.get("trace"), "acs_kernel")
    if own is None or acs is None:
        return None
    lo, hi = data["trace"]["units"]
    return own + 1e3 * acs / max(hi - lo, 1)
