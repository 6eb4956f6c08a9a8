"""The device symbol ring: demod output compacted per channel into a ring
of (symbol, cost) rows that the Viterbi decoder drains (the counterpart
of leansdr_tpu/fec/deconv_device.py:152-269, `deconv_append`).

Streams are [time, channel]. The append is one per-channel cumsum and
one scatter; it never reads a value back to the host.
"""

import torch

# Fleet drift window: channels whose fill lags the fleet maximum by more
# than DELTA_MAX symbols are dragged forward (see deconv_append).
DELTA_MAX = 256


def deconv_append(plan, state: dict, sym: torch.Tensor, valid: torch.Tensor,
                  cost: torch.Tensor | None = None) -> dict:
    """Compact new demod output into the ring.

    sym [n, C] u8, valid [n, C] bool, cost [n, C] i16 (with
    plan.store_costs). Returns the state dict with the new fill; the
    ring tensors state["buf"] / state["cost"] are updated IN PLACE (the
    JAX version returns new arrays; the port saves a ring copy per
    chunk).

    Ring contract (shared with the JAX version):
      * drift guard: fill = max(fill, max(fill) - (DELTA_MAX-1)), so a
        channel without a carrier (whose symbol count random-walks away
        from the fleet) is dragged forward instead of lagging without
        bound; the rows it skips hold whatever the ring held;
      * the valid symbols (and costs) land contiguously at the
        (dragged) fill, rows below it are untouched;
      * fill' = min(fill + nvalid, cap - DELTA_MAX - n);
      * rows at or past fill' hold garbage, which readers never look at
        (an underflowing decode is dropped by the host).
    """
    n, C = sym.shape
    fill = state["fill"]
    fill = torch.maximum(fill, fill.max() - (DELTA_MAX - 1))
    # Scan along time with time innermost: a scan over the outer dim of
    # [n, C] runs one sequential thread per channel on the GPU.
    csum = torch.cumsum(valid.t().to(torch.int32).contiguous(), dim=1,
                        dtype=torch.int32).t()
    nvalid = csum[-1]
    j = torch.arange(n, dtype=torch.int32, device=sym.device)[:, None]
    # Every source row gets its own slot in [fill, fill + n): valid rows
    # in stream order from fill, invalid rows after them (past the new
    # fill). Slots at or past the ring's end fold onto its last row,
    # which always lies past the new fill.
    row = torch.where(valid, fill + csum - 1, fill + nvalid + j - csum)
    row = row.clamp(max=plan.cap - 1).to(torch.int64)
    state["buf"].scatter_(0, row, sym.to(torch.uint8))
    if plan.store_costs:
        state["cost"].scatter_(0, row, cost.to(torch.int16))
    return dict(state, fill=(fill + nvalid).clamp(
        max=plan.cap - DELTA_MAX - n))
