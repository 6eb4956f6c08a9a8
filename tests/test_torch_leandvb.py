"""The port's leandvb end to end, and JAX checkpoints carried into it, in
processes that cannot import jax or leansdr_tpu (sys.modules entries set
to None), on the plain versions of the kernels (--device cpu).

1. `python -m leansdr_tpu_torch.apps.leandvb` alone from cold start to
   TS: 1.2 samples per symbol, rate 7/8 (the fewest samples per packet),
   32768 samples, --fastlock --fd-info. From the derandomizer's first
   sync on, every TS packet out is the next packet sent, and the info
   stream reports the lock.
2. A JAX DvbsReceiver (rate 7/8, --viterbi, --anf 1) runs 3 x 8192
   samples and saves its state; the JAX receiver resumed from that state
   and the port resumed from `convert.from_jax_dvbs_checkpoint` of it
   decode the next 8192 samples to the same TS (non-empty). The same
   process also carries the checkpoints of a hard-decision receiver and
   of a --resample --derotate one (their preprocessing state) across.

Tolerance: none; TS packets and carried state are compared exactly.
"""

import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from scipy.signal import resample_poly

from leansdr_tpu.pipelines import dvbs_rx as J

from leansdr_tpu_torch.pipelines import dvbs_tx, tsgen

# Single-threaded torch: the plain versions run many small ops, which
# OpenMP threads only slow down, most of all beside other test workers.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
NO_JAX = ("import sys\n"
          "for m in ('jax', 'jaxlib', 'leansdr_tpu'):\n"
          "    sys.modules[m] = None\n"
          "import torch\n"
          "torch.set_num_threads(1)\n")


def _stimulus(npkt, nsamp):
    """Rate 7/8 at 1.2 samples per symbol with a 0.3-sample delay and a
    small carrier offset, scaled to unit amplitude (--float-scale 75)."""
    iq = dvbs_tx.modulate(tsgen.generate(npkt),
                          dvbs_tx.TxConfig(rate="7/8", interp=2))
    z = resample_poly(iq[:, 0] + 1j * iq[:, 1], 6, 1)[3::10][:nsamp]
    z = z * np.exp(2j * np.pi * 3e-5 * np.arange(len(z)))
    assert len(z) == nsamp
    return np.stack([z.real, z.imag], -1).astype(np.float32)


def _run_jax_free(code: str, timeout=600, stdin=None):
    r = subprocess.run([sys.executable, "-c", NO_JAX + code], cwd=REPO,
                       input=stdin, capture_output=True, timeout=timeout)
    assert r.returncode == 0, r.stderr.decode()[-3000:]
    return r


def test_leandvb_cli_decodes_alone(tmp_path):
    x = _stimulus(42, 32768)
    info = tmp_path / "info.txt"
    code = (
        "import os, runpy\n"
        f"fd = os.open({str(info)!r}, os.O_WRONLY | os.O_CREAT)\n"
        "sys.argv = ['leandvb', '--f32', '--float-scale', '75', '-f', "
        "'2.4e6', '--sr', '2e6', '--cr', '7/8', '--fastlock', "
        "'--fd-info', str(fd), '--device', 'cpu']\n"
        "runpy.run_module('leansdr_tpu_torch.apps.leandvb', "
        "run_name='__main__')\n")
    r = _run_jax_free(code, stdin=x.tobytes())
    ts = np.frombuffer(r.stdout, np.uint8)
    assert len(ts) % 188 == 0
    pkts = ts.reshape(-1, 188)
    # Packets before the derandomizer's first inverted sync byte come out
    # unaligned (as in the reference); from the first sent one on, every
    # packet is the next one sent.
    sent = tsgen.generate(42)
    hit = [np.nonzero((sent == p).all(axis=1))[0] for p in pkts]
    i = next(k for k, h in enumerate(hit) if len(h))
    first = int(hit[i][0])
    assert len(pkts) - i >= 4, (len(pkts), i)
    np.testing.assert_array_equal(pkts[i:], sent[first:first + len(pkts) - i])
    lines = info.read_text().splitlines()
    assert lines[:4] == ["STANDARD DVB-S", "CONSTELLATION QPSK", "CR 7/8",
                         "SR 2000000.000000"]
    assert "LOCK 1" in lines and any(l.startswith("VBER") for l in lines)


def _jax_rx(**kw):
    return J.DvbsReceiver(J.RxConfig(use_pallas=True, exact_lut=False,
                                     float_scale=75.0, **kw))


def test_jax_checkpoint_continues_in_port(tmp_path):
    n = 8192
    x = _stimulus(60, 4 * n)
    kw = dict(Fs=2.4e6, Fm=2e6, rate="7/8", viterbi=True, fastlock=True,
              anf=1)
    a = _jax_rx(**kw)
    for k in range(3):
        a.process(x[k * n:(k + 1) * n])
    assert a.lock
    blob = a.save_state()
    b = _jax_rx(**kw)
    b.load_state(blob)
    want = b.process(x[3 * n:])
    assert len(want) >= 3

    hard = _jax_rx(Fs=2.4e6, Fm=2e6, rate="3/4", anf=1)
    res = _jax_rx(Fs=10e6, Fm=333e3, rate="1/2", resample=True,
                  Fderot=12e3, anf=0)
    res.process(np.ones((500, 2), np.float32))    # primes the resampler
    for name, obj in (("viterbi", blob), ("hard", hard.save_state()),
                      ("resample", res.save_state())):
        (tmp_path / f"{name}.pkl").write_bytes(obj)
    np.save(tmp_path / "x.npy", x[3 * n:])
    code = (
        "import pickle, numpy as np\n"
        "from pathlib import Path\n"
        "from leansdr_tpu_torch.convert import from_jax_dvbs_checkpoint\n"
        "from leansdr_tpu_torch.pipelines.dvbs_rx import DvbsReceiver, "
        "RxConfig\n"
        f"p = Path({str(tmp_path)!r})\n"
        "def rx(**kw):\n"
        "    return DvbsReceiver(RxConfig(exact_lut=False, float_scale=75.0,"
        " **kw), device='cpu')\n"
        "out = {}\n"
        f"t = rx(**{kw!r})\n"
        "t.load_state(from_jax_dvbs_checkpoint((p / 'viterbi.pkl')"
        ".read_bytes()))\n"
        "out['ts'] = t.process(np.load(p / 'x.npy'))\n"
        "h = rx(Fs=2.4e6, Fm=2e6, rate='3/4', anf=1)\n"
        "h.load_state(from_jax_dvbs_checkpoint((p / 'hard.pkl')"
        ".read_bytes()))\n"
        "out['hard'] = (h.deconv.locked, h.deconv.skip, "
        "h.notch.b.slot_i.tolist(), h.notch.b.phase)\n"
        "r = rx(Fs=10e6, Fm=333e3, rate='1/2', resample=True, "
        "Fderot=12e3, anf=0)\n"
        "r.load_state(from_jax_dvbs_checkpoint((p / 'resample.pkl')"
        ".read_bytes()))\n"
        "out['res'] = (r.resampler.hist, r.resampler._primed, "
        "r.derot.index, r.sample_backlog)\n"
        "out['mods'] = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'leansdr_tpu') and sys.modules[m] is not None)\n"
        "(p / 'out.pkl').write_bytes(pickle.dumps(out))\n")
    _run_jax_free(code)
    out = pickle.loads((tmp_path / "out.pkl").read_bytes())
    assert out["mods"] == []
    np.testing.assert_array_equal(out["ts"], want)
    assert out["hard"] == (hard.deconv.locked, hard.deconv.skip,
                           [hard.notch.slot_i.tolist()], hard.notch.phase)
    hist, primed, index, backlog = out["res"]
    np.testing.assert_array_equal(hist, res.resampler.hist)
    assert primed and index == res.derot.index
    np.testing.assert_array_equal(backlog, res.sample_backlog)
