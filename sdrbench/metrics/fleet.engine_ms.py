"""Segmented demod engine (pipelines/multi_rx._demod_segmented): device
ms per chunk of its own operations (window stacking, relabel, cuts,
derotation, splice), from the profiler: those launched under the engine's
scope and outside the matched filter's and the demod's scopes inside
it."""
from sdrbench.metrics._common import scope_ms_per_input


def read(data):
    return scope_ms_per_input(data, "segmented")
