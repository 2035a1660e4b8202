"""Straggler mitigation for synchronous gs-SGD: drop-after-deadline.

Port of ``repro/runtime/straggler.py`` (pure Python and NumPy; the same
code, over the port's ``obs.trace``).

Synchronous SGD waits for the slowest worker. gs-SGD admits a cheap
policy *because sketch merge is linear*: a straggler's sketch can simply
be left out of the sum — the merged sketch is then an exact sketch of the
LIVE workers' gradient sum. The aggregation is rescaled by P/live
(unbiased estimate of the full sum), and the dropped worker keeps its
entire update in its error-feedback accumulator, so its gradient is
applied on the next step rather than lost — the same mechanism that
absorbs compression error absorbs the drop.

``include``-mask support is implemented inside the sketch compressors
(``core/compression.GsSGD.step(include=...)``, and the train step's
``fn(state, batch, include)``); this module provides the policy that
produces the mask and the bookkeeping around it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.obs import trace as obtrace


@dataclasses.dataclass
class DeadlinePolicy:
    """Drop workers whose step time exceeds ``factor`` x running median.

    ``observe`` feeds per-worker step durations (seconds); ``mask`` returns
    a bool vector (True = include). ``max_drop_frac`` bounds how many
    workers may be dropped in one step (the fastest are kept).
    """

    factor: float = 3.0
    max_drop_frac: float = 0.25
    window: int = 32

    def __post_init__(self):
        self._hist: list[np.ndarray] = []

    def observe(self, durations) -> None:
        self._hist.append(np.asarray(durations, dtype=np.float64))
        if len(self._hist) > self.window:
            self._hist.pop(0)

    def mask(self, durations) -> np.ndarray:
        d = np.asarray(durations, dtype=np.float64)
        if not self._hist:
            med = np.median(d)
        else:
            med = np.median(np.concatenate(self._hist))
        include = d <= self.factor * max(med, 1e-9)
        max_drop = int(len(d) * self.max_drop_frac)
        if (~include).sum() > max_drop:
            # keep the fastest; drop only the worst ``max_drop``
            order = np.argsort(d)
            include = np.zeros(len(d), bool)
            include[order[:len(d) - max_drop]] = True
        if not include.all():
            # positions are caller-relative (the caller maps them to
            # worker ids); the deadline is the policy's decision boundary
            obtrace.current().instant(
                "straggler.drop", cat="runtime",
                args={"dropped": [int(i) for i in np.nonzero(~include)[0]],
                      "deadline": float(self.factor * max(med, 1e-9))})
        return include
