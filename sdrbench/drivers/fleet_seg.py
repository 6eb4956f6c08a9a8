"""Driver of the segmented fleet (MultiDvbsReceiver with segments > 1)
checked against reference_seg.py's engine, whose handover pairs the two
trajectories' emissions as their sequences align: drivers/fleet.py in
all else. The run also prints, as a diagnostic, the share of rows of the
sampled chunk where the program differs from reference.py's engine (the
first anchor of any alignment), and the program's handover counters over
the whole run (`seg.*`, where it has them)."""

from sdrbench import reference_seg
from sdrbench.check import compare_soft
from sdrbench.drivers import fleet

_program = fleet._program       # the program's modules, as fleet.py calls them


class Driver(fleet.Driver):
    """One run of a segmented fleet cell (drivers/fleet.Driver)."""

    def reference_demod(self, precision: str = "fp32"):
        rc = self.cfg["receiver"]
        pll = 1.0 / 6 if rc["viterbi"] else 1.0
        return reference_seg.Demod(rc["Fs"], rc["Fm"], rc["rolloff"],
                                   rc["rrc_rej"], pll, self.device,
                                   precision)

    def check(self) -> dict:
        out = super().check()
        if "seg" in self.captured:
            S, W, dem_in, seg_in, prog = self.captured["seg"]
            cs = self.ref_carriers
            old = super().reference_demod().segmented(
                S, W, dem_in[:, cs], seg_in[:, self._lanes(S)],
                self.chunks_for_check["chunk"])[2:]
            self.diagnostics["demod_diff_first_anchor"] = compare_soft(
                *old, *(a[:, cs] for a in prog[2:]))
        self.diagnostics.update(_handover_counts())
        return out


def _handover_counts() -> dict:
    """The program's `seg.*` counters (boundaries, blind, relabel,
    realigned) so far, as seg_<name>; none for a program without them."""
    try:
        from leansdr_tpu_torch.util import trace
    except ImportError:
        return {}
    return {"seg_" + k[4:]: v for k, v in trace.counters().items()
            if k.startswith("seg.")}
