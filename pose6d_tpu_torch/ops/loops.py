"""Data-dependent loops that torch.export can trace.

Each such loop of the port (LOBPCG's stop rule, RANSAC's adaptive exit,
the FPS chain) is one out-of-place step over a tuple of tensors and a
condition that returns a 0-d bool tensor. `run_while` drives the step:
eagerly by a Python loop that reads the condition on the host once per
step (or, for a fixed trip count, reads nothing), and, while
torch.export traces, by the `while_loop` higher-order op, which the
exported program replays reading the condition once per step. Both run
the same step in the same order, so a live call and its exported
program give the same bits on one device. The counterpart of
`lax.while_loop` / `lax.fori_loop` in the JAX package.
"""
from __future__ import annotations

import torch


def run_while(cond, body, state: tuple, steps: int | None = None) -> tuple:
    """state = body(*state) while cond(*state); returns the last state.

    cond(*state) -> 0-d bool tensor; body(*state) -> a tuple of tensors
    of the same shapes, dtypes and strides, computed without writing into
    the state's tensors. steps: the trip count, when the caller knows it
    (cond then holds for exactly `steps` steps): the eager loop runs that
    many steps without reading cond, as lax.fori_loop does."""
    state = tuple(state)
    if torch.compiler.is_exporting():
        from torch._higher_order_ops.while_loop import while_loop
        return tuple(while_loop(cond, body, state))
    if steps is not None:
        for _ in range(steps):
            state = tuple(body(*state))
        return state
    while bool(cond(*state)):
        state = tuple(body(*state))
    return state

