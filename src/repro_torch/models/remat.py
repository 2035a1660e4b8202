"""Recomputed regions: the reference's ``jax.checkpoint`` in autograd.

``remat_call(fn, *args)`` runs ``fn(*args)`` so that autograd keeps none
of the tensors the region saves for its backward. Each is packed as an
empty holder (``torch.autograd.graph.saved_tensors_hooks``); the first
time the backward unpacks one, the region runs ``fn`` once more on its
inputs, and that run's saved tensors, in the same order, fill the
holders; it stops at the last of them (so a trailing collective whose
result no backward reads runs once, as under XLA's remat). The backward
itself runs on the first forward's graph, so a
tensor the region reads from outside its arguments (a closure's
parameters) gets its gradient as it would without the recompute, and
the values are the same ops on the same inputs: bit for bit those of a
plain call.

The region's own inputs are saved through the hooks active around the
call. Inside another region they are that region's holders: a nested
region keeps nothing, and its inputs are recomputed with the enclosing
region (the sqrt-n cycle groups of ``models.model``); at the top level
they are kept.

This is ``torch.utils.checkpoint``'s non-reentrant scheme without its
options, and without its first call's import of ``torch._dynamo``,
which takes seconds in every process that trains. Nothing in a region
draws random numbers, so no RNG state is saved. A recompute runs under a
``remat/recompute`` span (cat ``detail``, ``obs/trace.py``).
"""

from __future__ import annotations

import weakref

import torch

from repro_torch.obs import trace as obtrace


class _Filled(Exception):
    """Raised by a recompute's last save: the region's holders are full."""


class _Holder:
    """One saved tensor of a region: empty until the region recomputes."""

    __slots__ = ("value", "__weakref__")

    def __init__(self):
        self.value = None


class _SaveInputs(torch.autograd.Function):
    """A region's tensor inputs, saved through the hooks active at the
    call (an enclosing region's holders, or the tensors themselves)."""

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return args[0].new_empty(0)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("a region's saved inputs have no gradient")


class _Region:
    """One ``remat_call``: its function, how to get its inputs back, and
    the holders of what it saved, in save order."""

    def __init__(self, fn, args):
        self.fn = fn
        self.slots = [None if isinstance(a, torch.Tensor) else a
                      for a in args]
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        self.flags = [t.requires_grad for t in tensors]
        self.kept = None
        self.saver = None
        if any(self.flags):
            self.saver = _SaveInputs.apply(*tensors)
        else:
            self.kept = tensors
        self.holders: list = []
        self.recomputed = False

    def pack(self, t):
        h = _Holder()
        self.holders.append(weakref.ref(h))
        return h

    def unpack(self, h):
        if not self.recomputed:
            self.recompute()
        return h.value

    def recompute(self) -> None:
        """Run the region again, filling the holders in save order, and
        stop at its last saved tensor: what follows it (a row-parallel
        psum whose sum no backward reads) is not run again."""
        saved = (self.kept if self.saver is None
                 else self.saver.grad_fn.saved_tensors)
        tensors = iter(t.detach().requires_grad_(f)
                       for t, f in zip(saved, self.flags))
        args = [next(tensors) if a is None else a for a in self.slots]
        refs = iter(self.holders)
        left = [len(self.holders)]

        def fill(t):
            h = next(refs)()
            if h is not None:
                h.value = t.detach()
            left[0] -= 1
            if not left[0]:
                raise _Filled
            return None

        # on autograd's thread: the span does not sync
        try:
            with obtrace.current().span("remat/recompute", cat="detail"), \
                    torch.autograd.graph.saved_tensors_hooks(
                        fill, lambda _: None), torch.enable_grad():
                self.fn(*args)
        except _Filled:
            pass
        self.recomputed = True


def remat_call(fn, *args):
    """``fn(*args)`` as a recomputed region (module docstring) when
    autograd records; a plain call otherwise. ``args`` are tensors and
    plain values; ``fn`` may read other tensors from its closure."""
    if not torch.is_grad_enabled():
        return fn(*args)
    region = _Region(fn, args)
    with torch.autograd.graph.saved_tensors_hooks(region.pack, region.unpack):
        return fn(*args)
