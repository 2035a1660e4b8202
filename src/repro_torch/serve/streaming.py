"""Token-by-token streaming: stop conditions + per-request generators.

Port of ``repro/serve/streaming.py`` (pure Python, unchanged).

The engine emits ``(rid, token, t_virtual, t_wall)`` tuples as decode
steps complete; ``stream_tokens`` wraps that into the familiar generator
interface — the caller iterates tokens for ONE request while the engine
keeps continuous-batching every co-resident request underneath.
"""

from __future__ import annotations

from typing import Iterator


def stop_reason(n_emitted: int, n_prior: int, max_new: int,
                stop_token: int | None, last_token: int,
                next_pos: int, max_len: int) -> str | None:
    """Why a request finishes after emitting ``last_token`` (or ``None``
    to keep decoding).

    Checked in priority order: explicit stop token beats the length
    budget, which beats the hard cache-capacity ceiling. ``n_prior`` is
    the token count carried over a failover replay — the budget covers
    the LOGICAL sequence, not one replica's share of it.
    """
    if stop_token is not None and last_token == stop_token:
        return "stop"
    if n_prior + n_emitted >= max_new:
        return "length"
    if next_pos >= max_len:  # cache full: cannot place another token
        return "length"
    return None


def stream_tokens(engine, request) -> Iterator[int]:
    """Submit ``request`` and yield its tokens as they are generated.

    Pull-driven: each ``next()`` steps the engine until the request
    emits (other requests' tokens accumulate in ``engine.emissions`` as
    usual). StopIteration fires when the request completes — including a
    deadline drop, so callers must check ``engine.completion(rid)`` if
    they need the finish reason.
    """
    engine.submit(request)
    cursor = len(engine.emissions)
    while engine.completion(request.rid) is None:
        if not engine.pending():
            break
        engine.step()
        for rid, tok, _tv, _tw in engine.emissions[cursor:]:
            if rid == request.rid:
                yield tok
        cursor = len(engine.emissions)
