"""Loops whose trip count grows with the input: a Python loop when run,
one ``torch._higher_order_ops.scan`` of the same step under torch.export
(exporting.py), so that an exported program does not grow with the audio
length or the decode length."""

from __future__ import annotations

import torch


def scan_steps(step, carry: tuple, xs: tuple):
    """carry, y = step(carry, *(x[t] for x in xs)) for t = 0 .. n-1, n =
    xs[0].shape[0] -> (the last carry, the ys stacked on a new leading
    axis: a tuple of (n, ...) tensors). step returns its y as a tuple of
    tensors (possibly empty)."""
    if torch.compiler.is_exporting():
        from torch._higher_order_ops import scan

        def body(carry, x):
            carry, y = step(carry, *x)
            # a scan body's outputs may not alias one another (a y that is
            # also a carry is copied), and it returns at least one y (a
            # scalar, dropped after)
            y = tuple(t.clone() if any(t is c for c in carry) else t
                      for t in y)
            return carry, (*y, carry[0].new_zeros(()))

        carry, ys = scan(body, tuple(t.contiguous() for t in carry), xs)
        return carry, tuple(ys[:-1])
    ys = []
    for t in range(xs[0].shape[0]):
        carry, y = step(carry, *(x[t] for x in xs))
        ys.append(y)
    if not ys or not ys[0]:
        return carry, ()
    return carry, tuple(torch.stack(col) for col in zip(*ys))
