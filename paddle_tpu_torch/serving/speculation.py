"""Model-free speculative drafting for the serving engine.

Counterpart of ``paddle_tpu/serving/speculation.py`` (the port keeps its
own copy: it imports nothing of the JAX package). Prompt-lookup (n-gram)
decoding: LLM outputs constantly re-emit spans of their own context —
retrieved quotes, code identifiers, repeated boilerplate, greedy cycles —
so a draft for the next K tokens can be read straight out of the
request's prompt+output history instead of a separate draft model. The
drafter finds earlier occurrences of the trailing n-gram and proposes the
tokens that followed; the engine then scores all K+1 positions in ONE
batched ``verify`` launch (adapter entry point) and accepts the longest
draft prefix that matches the target model's own greedy argmax. Accepted
tokens are exactly what step-by-step decode would have produced, so
greedy outputs stay token-identical — speculation only changes how many
launches it takes to produce them.

Everything here is host-side pure Python over token lists: no tensors,
no randomness. The drafter's output is padded to a fixed width by the
engine, so the captured ``verify`` program never sees a data-dependent
shape.
"""
from __future__ import annotations

__all__ = ["propose", "accept_length", "DEFAULT_LOOKBACK"]

# how far back the drafter searches for the trailing n-gram: recent
# history carries the repetition worth exploiting (the current
# quote/cycle/boilerplate span), and an unbounded scan would make the
# host-side cost per step grow linearly with context length — paid on
# the latency-critical path, and highest exactly when nothing matches
DEFAULT_LOOKBACK = 512


def propose(history, k, max_ngram=3, min_ngram=1,
            lookback=DEFAULT_LOOKBACK):
    """Draft up to ``k`` continuation tokens for ``history`` (prompt +
    generated tokens so far) by prompt lookup.

    Tries the trailing ``n``-gram for ``n`` from ``max_ngram`` down to
    ``min_ngram``; the FIRST n with an earlier occurrence wins (longer
    context disambiguates better). Among occurrences, recency tracks
    the current generation phase, but two refinements buy precision —
    a rejected draft costs nothing extra in launch time (the verify
    window has a fixed shape), yet every accepted token is a decode
    launch saved, so the drafter optimizes accept RATE:

      * a match flush against the tail would truncate the draft (a
        period-p cycle matched at distance p proposes only p tokens),
        so the most recent occurrence with a FULL ``k``-token
        continuation is preferred, nearer-but-shorter ones kept only
        as a fallback;
      * quasi-periodic histories carry several variants of the same
        n-gram context; where the two most recent full continuations
        DISAGREE the evidence is ambiguous, so the draft is truncated
        at their longest common prefix (falling back to one token of
        the most recent when they disagree immediately).

    Only the last ``lookback`` tokens are searched (bounded host cost
    per step regardless of context length). Returns at most ``k``
    tokens — possibly fewer or empty (no repetition to exploit, or
    ``k <= 0``). Deterministic, read-only.
    """
    if k <= 0 or lookback <= 0:
        return []
    k = int(k)
    hist = [int(t) for t in history[-int(lookback):]]
    n_hi = min(int(max_ngram), len(hist) - 1)
    for n in range(n_hi, max(int(min_ngram), 1) - 1, -1):
        tail = hist[-n:]
        full = []      # most-recent-first continuations of k tokens
        short = None   # nearest shorter continuation (fallback)
        for start in range(len(hist) - n - 1, -1, -1):
            if hist[start:start + n] == tail:
                cont = hist[start + n:start + n + k]
                if len(cont) == k:
                    full.append(cont)
                    if len(full) == 2:
                        break
                elif short is None:
                    short = cont
        if len(full) == 2:
            a, b = full
            m = 0
            while m < k and a[m] == b[m]:
                m += 1
            return a[:m] if m else a[:1]
        if full:
            return full[0]
        if short is not None:
            return short
    return []


def accept_length(draft, targets):
    """Longest accepted draft prefix: ``draft[j]`` is accepted when it
    equals ``targets[j]`` — the target model's greedy argmax at the
    position draft[j] would occupy (``verify``'s logits row j scores
    the token FOLLOWING position j). Rejection is sticky: the first
    mismatch invalidates everything after it, because later drafts
    were scored in a context containing the rejected token."""
    a = 0
    for d, t in zip(draft, targets):
        if int(d) != int(t):
            break
        a += 1
    return a
