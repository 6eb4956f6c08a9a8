"""The loop-carried dependency chain of a CUDA kernel's inner loop, read
from `cuobjdump -sass` text.

    python tools/sass_chain.py KERNEL.sass FUNCTION_SUBSTRING \\
        [--latency LAT.json] [--marker STS] [--also MUFU|none]
        [--per-step 1]

The inner loop is the smallest backward branch of the function whose
body holds both the marker opcode and the `also` opcode (the demod: its
store of its packed word, `STS`, once per sample, and `MUFU`; the ACS
kernels hold no MUFU, so `also` is none there and the marker is their
warp reduction, `REDUX`); the number of markers in the body over
`per_step`, the markers per loop step, is its unroll factor. The hot
path leaves out each block that a
forward branch jumps over and that holds a call, a global or local
memory access or a loop of its own, but no `MUFU`: the slow paths of
IEEE cosf/sinf (Payne-Hanek reduction) and of division. (The division's
own fast path, `MUFU.RCP` and its refinement, sits in a block that a
zero-divisor test jumps over; it stays.) An unconditional forward
branch's skipped block (the other arm of an if/else) is left out too;
with `hot_loads` (the scan demods), unless the if-arm before it was left
out (a general loop beside its fast path), and blocks are then judged
innermost first (`hot_path`).

The hot instructions run in address order, as one straight line, pass
after pass with unlimited issue: each starts when the registers and
predicates it reads are ready (a guarded write also reads its old
destination) and takes its opcode's latency. The growth of the finish
time per pass, over the unroll factor, is the chain per loop step in
cycles: the least time one step can take however the instructions are
scheduled, since only data dependencies are kept (not issue slots, not
branches). Beside it, `issue_cycles_per_step`: the same instructions
issued in their compiled order by one warp alone on its scheduler, one
per cycle at most, each waiting for its operands (what the compiled
schedule costs such a warp). With `exchange`, a loop whose threads
swap data through shared memory behind a barrier each step (the banked
ACS) has that path counted too: a store (STS) feeds the next barrier
(BAR), which feeds every later shared-memory load (LDS), priced at the
table's STS, BAR and LDS entries (chip_smoke.py measures the round
STS + BAR.SYNC + LDS on the card), and a warp issues nothing past a
barrier until it has passed; a block that a guarded forward branch
skips and that holds a barrier is a step taken in some passes only (the
banked ACS's once-per-64-blocks reduction) and is left out. Latencies come from a table keyed by opcode
family, or family and first modifier ("MUFU.RCP"); chip_smoke.py measures one on the card
with tools/latency_probe.cu. A family missing from the table is priced
at the table's `fixed` entry and reported. A load from a table in
shared memory (the QPSK demod's phase error, `LDS.S16`) is priced at
its own key where the table has one, else at LDS (the probe's
conflict-free chase: the least it can take).

Beside the count, `path_mix` names where the chain's time goes: each
opcode (with its first modifier) on the dependency path that reaches
the latest finish, its count and cycles per step (the demod's table
instance shows its table load there, and its off-grid computation,
called out of line, nowhere).
"""

import json
import re
import sys
from dataclasses import dataclass

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_FUNC = re.compile(r"Function : (\S+)")
_REG = re.compile(r"(?<![\w.])(U?R\d+|U?P\d)(\.64|\.128)?")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)$")
_PRED = re.compile(r"!?U?P(\d|T)")

# Opcodes that write no register (stores, control flow, barriers).
_NO_DEST = {"ST", "STS", "STG", "STL", "RED", "BRA", "EXIT", "BAR", "RET",
            "CALL", "WARPSYNC", "BSYNC", "BSSY", "NOP", "DEPBAR", "MEMBAR",
            "ERRBAR", "YIELD", "LDGSTS", "LDGDEPBAR", "JMP", "BPT", "CCTL",
            "ATOMS", "ARRIVES", "SYNCS", "BREAK", "KILL"}
# Opcodes whose leading predicate operands are all destinations.
_PRED_DEST = {"ISETP", "FSETP", "DSETP", "HSETP2", "PSETP", "FCHK", "PLOP3",
              "R2P", "VOTE"}
# A block holding one of these (and no MUFU) is a slow path.
_SLOW = {"CALL", "LDG", "LDL", "STL", "LD", "ST"}
_CONST = {"RZ", "URZ", "PT", "UPT"}


@dataclass
class Instr:
    addr: int
    pred: str          # guard ("" or "P0", "!P0", ...)
    op: str            # opcode with modifiers ("FRND.TRUNC")
    operands: list
    text: str

    @property
    def family(self) -> str:
        return self.op.split(".")[0]


def functions(text: str) -> dict:
    """{function name: its lines} of a cuobjdump -sass listing."""
    out, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = m.group(1)
            out[cur] = []
        elif cur is not None:
            out[cur].append(line)
    return out


def parse(lines) -> tuple:
    """(instructions in address order, {label: address})."""
    instrs, labels, pending = [], {}, []
    for line in lines:
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.search(line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        body = m.group(2).strip()
        pred = ""
        if body.startswith("@"):
            pred, body = body.split(None, 1)
            pred = pred[1:]
        parts = body.split(None, 1)
        ops = ([o.strip() for o in parts[1].split(",")]
               if len(parts) > 1 else [])
        for name in pending:
            labels[name] = addr
        pending = []
        instrs.append(Instr(addr, pred, parts[0], ops, body))
    return instrs, labels


def target(ins: Instr, labels: dict):
    """The address a branch goes to, or None."""
    if ins.family != "BRA":
        return None
    m = _TARGET.search(ins.text)
    if not m:
        return None
    return labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)


def _regs(operand: str) -> list:
    """Registers an operand names (pairs and quads spelled out); RZ, PT,
    URZ and UPT are constants."""
    out = []
    for name, width in _REG.findall(operand):
        kind = name.rstrip("0123456789")
        idx = int(name[len(kind):])
        out += [f"{kind}{idx + i}"
                for i in range({"": 1, ".64": 2, ".128": 4}[width])]
    return out


# Pseudo-registers of the shared-memory exchange (analyse(exchange=True)).
_STORED, _VISIBLE = "SMEM.stored", "SMEM.visible"


def dests_sources(ins: Instr, exchange: bool = False) -> tuple:
    """(registers written, registers read) of one instruction; a guarded
    write also reads its destination (it keeps the old value when the
    guard is false). With `exchange`, stores to shared memory write
    _STORED, a barrier reads it and writes _VISIBLE, and shared-memory
    loads read _VISIBLE."""
    dests, srcs = _dests_sources(ins)
    if exchange:
        if ins.family == "STS":
            dests = dests + [_STORED]
        elif ins.family == "BAR":
            dests, srcs = dests + [_VISIBLE], srcs + [_STORED]
        elif ins.family == "LDS":
            srcs = srcs + [_VISIBLE]
    return dests, srcs


def _dests_sources(ins: Instr) -> tuple:
    srcs = _regs(ins.pred)
    ops = list(ins.operands)
    dests = []
    if ins.family in _NO_DEST:
        ops, srcs = [], srcs + [r for o in ops for r in _regs(o)]
    elif ins.family in _PRED_DEST:
        while ops and _PRED.fullmatch(ops[0]):
            dests += _regs(ops.pop(0))
    elif ops:
        # A leading predicate is a destination too (SHFL PT, R1, ...;
        # LOP3.LUT P0, RZ, ...).
        while ops and _PRED.fullmatch(ops[0]):
            dests += _regs(ops.pop(0))
        width = (2 if ".64" in ins.op or ".WIDE" in ins.op
                 else 4 if ".128" in ins.op else 1)
        for r in _regs(ops.pop(0) if ops else ""):
            kind = r.rstrip("0123456789")
            dests += [f"{kind}{int(r[len(kind):]) + i}" for i in range(width)]
        while ops and _PRED.fullmatch(ops[0]):
            dests += _regs(ops.pop(0))
    srcs += [r for o in ops for r in _regs(o)]
    if ins.pred:
        srcs += dests
    return dests, srcs


def inner_loop(instrs, labels, marker="STS", also="MUFU",
               min_markers=1) -> tuple:
    """(first, last) indices of the smallest loop holding at least
    `min_markers` `marker` opcodes and (unless `also` is None) an `also`
    opcode. (A compiler that versions a loop on a flag, as the parent ACS
    kernel's on cheap_q, leaves two such loops: min_markers picks the
    larger.)"""
    index = {ins.addr: i for i, ins in enumerate(instrs)}
    best = None
    for j, ins in enumerate(instrs):
        t = target(ins, labels)
        if t is None or t > ins.addr or t not in index:
            continue
        i = index[t]
        fams = {x.family for x in instrs[i:j + 1]}
        count = sum(x.family == marker for x in instrs[i:j + 1])
        if count >= min_markers and (also is None or also in fams) and (
                best is None or j - i < best[1] - best[0]):
            best = (i, j)
    if best is None:
        raise ValueError(f"no loop holding {marker} and {also}")
    return best


def hot_path(instrs, labels, first, last, exchange=False,
             hot_loads=False) -> list:
    """The loop body less its slow-path blocks and else-arms (see the
    module docstring), without the branches themselves; with `exchange`,
    also less each block a guarded forward branch skips that holds a
    barrier (a step taken in some passes only). With `hot_loads` (the
    scan demods' emitting step, which gathers its tables and holds the
    rrc window's general loop beside its fast path), a block's global
    loads (LDG) do not make it a slow path, blocks are judged innermost
    first without the nested blocks already left out, and an else-arm
    whose if-arm is left out is judged like any block. (Without it, a
    block holding a nested slow path is left out whole: the demod's
    large-argument sincos block holds an infinity test and its x * 0
    beside the Payne-Hanek loop.)"""
    slow = _SLOW - {"LDG"} if hot_loads else _SLOW
    index = {ins.addr: i for i, ins in enumerate(instrs)}
    skipped = []
    for j in range(first, last):
        t = target(instrs[j], labels)
        if t is None or t <= instrs[j].addr or index.get(t, last + 1) > last:
            continue
        skipped.append((j, index[t]))
    cold = set()

    def is_slow(j, end):
        block = [k for k in range(j + 1, end) if k not in cold]
        fams = {instrs[k].family for k in block}
        loops = any((target(instrs[k], labels) or 1 << 62)
                    <= instrs[k].addr for k in block)
        return ("MUFU" not in fams and (fams & slow or loops)) or (
            exchange and "BAR" in fams)

    if not hot_loads:
        for j, end in skipped:
            if not instrs[j].pred or is_slow(j, end):
                cold.update(range(j + 1, end))
    else:
        # The scan demods' emitting step holds the rrc window's general
        # loop beside its fast path: guarded blocks innermost first, each
        # judged on what is left of it once the blocks nested in it that
        # are left out are gone; then the else-arms (the blocks
        # unconditional branches skip): left out, unless the if-arm before
        # it was, when the else-arm is judged like any block.
        guarded = sorted((b for b in skipped if instrs[b[0]].pred),
                         key=lambda b: b[1] - b[0])
        for j, end in guarded:
            if is_slow(j, end):
                cold.update(range(j + 1, end))
        for j, end in sorted((b for b in skipped if not instrs[b[0]].pred),
                             key=lambda b: b[1] - b[0]):
            if_arm_cold = any(e == j + 1 and all(
                k in cold for k in range(g + 1, j + 1)) for g, e in guarded)
            if not if_arm_cold or is_slow(j, end):
                cold.update(range(j + 1, end))
    return [instrs[k] for k in range(first, last + 1)
            if k not in cold and instrs[k].family != "BRA"]


def latency_of(ins: Instr, latency: dict) -> float:
    parts = ins.op.split(".")
    for key in (".".join(parts[:2]), parts[0]):
        if key in latency:
            return latency[key]
    return latency["fixed"]


def _schedule(body, latency: dict, passes: int, exchange: bool) -> list:
    """The latest finish after each pass of `body` with unlimited issue,
    as (time, instructions on the path to it, the path's last node); a
    node is (pass, index in body, the node it waited for)."""
    deps = [dests_sources(i, exchange) + (latency_of(i, latency),)
            for i in body]
    ready, finish, end = {}, [], (0.0, 0, None)
    for p in range(passes):
        for k, (dsts, srcs, lat) in enumerate(deps):
            t, n, prev = max((ready.get(r, (0.0, 0, None)) for r in srcs),
                             default=(0.0, 0, None), key=lambda v: v[:2])
            done = (t + lat, n + 1, (p, k, prev))
            for r in dsts:
                if r == _STORED:       # a barrier waits for every store
                    ready[r] = max(ready.get(r, done), done,
                                   key=lambda v: v[:2])
                elif r not in _CONST:
                    ready[r] = done
            end = max(end, done, key=lambda v: v[:2])
        finish.append(end)
    return finish


def chain_cycles(body, latency: dict, passes: int = 24,
                 exchange: bool = False) -> tuple:
    """(cycles, instructions) per pass of the loop-carried chain of
    `body`: the growth per pass of the latest finish and of the number of
    instructions on the dependency path that reaches it."""
    finish = _schedule(body, latency, passes, exchange)
    half = passes // 2
    span = passes - half
    return ((finish[-1][0] - finish[half - 1][0]) / span,
            (finish[-1][1] - finish[half - 1][1]) / span)


def chain_path(body, latency: dict, passes: int = 24,
               exchange: bool = False) -> dict:
    """{opcode: (count, cycles)} per pass of the instructions on the
    dependency path that reaches the latest finish, over the second half
    of the passes (opcodes with their first modifier, as the latency
    table keys them: where the loop-carried time goes)."""
    node = _schedule(body, latency, passes, exchange)[-1][2]
    half = passes // 2
    span = passes - half
    out = {}
    while node is not None and node[0] >= half:
        ins = body[node[1]]
        key = ".".join(ins.op.split(".")[:2])
        n, c = out.get(key, (0, 0.0))
        out[key] = (n + 1, c + latency_of(ins, latency))
        node = node[2]
    return {k: (n / span, c / span) for k, (n, c) in sorted(out.items())}


def issue_cycles(body, latency: dict, passes: int = 24,
                 exchange: bool = False) -> float:
    """Cycles per pass of `body` for one warp issuing alone, in order:
    one instruction per cycle at most, each waiting for the registers
    and predicates it reads (the compiled schedule's own bound, which a
    warp without a neighbour on its scheduler cannot beat); with
    `exchange` the warp also waits at each barrier until it passes."""
    deps = [dests_sources(i, exchange) + (latency_of(i, latency),
                                          exchange and i.family == "BAR")
            for i in body]
    ready, t, ends = {}, 0.0, []
    for _ in range(passes):
        for dsts, srcs, lat, blocks in deps:
            t = max([t + 1.0] + [ready.get(r, 0.0) for r in srcs])
            for r in dsts:
                if r not in _CONST:
                    ready[r] = t + lat
            if blocks:
                t += lat
        ends.append(t)
    half = passes // 2
    return (ends[-1] - ends[half - 1]) / (passes - half)


def analyse(text: str, function: str, latency: dict, marker="STS",
            also="MUFU", per_step=1.0, min_markers=1,
            exchange=False, hot_loads=False) -> dict:
    """The chain per loop step of `function` (a substring of its mangled
    name) in a cuobjdump -sass listing, with the loop's instruction mix.
    The loop holds at least `min_markers` of `marker` (and `also`,
    unless None); `per_step` markers make one step; `exchange` counts the
    shared-memory exchange behind each barrier (module docstring);
    `hot_loads` keeps blocks with global loads on the hot path."""
    funcs = functions(text)
    names = [f for f in funcs if function in f]
    if len(names) != 1:
        raise ValueError(f"{len(names)} functions match {function!r}")
    instrs, labels = parse(funcs[names[0]])
    first, last = inner_loop(instrs, labels, marker, also, min_markers)
    body = hot_path(instrs, labels, first, last, exchange, hot_loads)
    unroll = sum(i.family == marker for i in body) / per_step
    mix = {}
    for i in body:
        mix[i.family] = mix.get(i.family, 0) + 1
    known = {k.split(".")[0] for k in latency}
    cycles, on_path = chain_cycles(body, latency, exchange=exchange)
    path = chain_path(body, latency, exchange=exchange)
    return dict(function=names[0],
                loop=[f"{instrs[first].addr:#x}", f"{instrs[last].addr:#x}"],
                hot_instructions=len(body), unroll=unroll,
                cycles_per_step=cycles / unroll,
                issue_cycles_per_step=issue_cycles(
                    body, latency, exchange=exchange) / unroll,
                path_instructions_per_step=on_path / unroll,
                path_mix={k: (n / unroll, c / unroll)
                          for k, (n, c) in path.items()},
                instructions_per_step=len(body) / unroll, mix=mix,
                priced_as_fixed=sorted(set(mix) - known))


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sass")
    ap.add_argument("function")
    ap.add_argument("--latency", help="JSON {family: cycles, 'fixed': c}")
    ap.add_argument("--marker", default="STS")
    ap.add_argument("--also", default="MUFU",
                    help="an opcode the loop also holds, or 'none'")
    ap.add_argument("--per-step", type=float, default=1.0,
                    help="markers per loop step")
    ap.add_argument("--exchange", action="store_true",
                    help="count the shared-memory exchange behind barriers")
    ap.add_argument("--hot-loads", action="store_true",
                    help="keep blocks with global loads (LDG) hot")
    a = ap.parse_args(argv)
    lat = json.load(open(a.latency)) if a.latency else {"fixed": 4.0}
    also = None if a.also.lower() == "none" else a.also
    print(json.dumps(analyse(open(a.sass).read(), a.function, lat,
                             a.marker, also, a.per_step,
                             exchange=a.exchange, hot_loads=a.hot_loads),
                     indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
