"""On-device batched decoding: greedy, temperature sampling, beam search.

This replaces the costliest pattern in the reference (SURVEY §3.3/3.4): host-side loops issuing one ``sess.run`` per token
(``vae_model/decoder.py:145-201``) and one per *beam* per step
(``:203-320`` + ``utils/top_n.py`` heaps) — ~300 device round-trips per
image at beam 10.  Here the whole decode is one ``lax.scan`` inside one
jit over a ``[batch, beam]`` state: zero host syncs until the final
token array is fetched.

Semantics preserved from the reference beam search:
  * log-prob accumulation with the ``p < 1e-12`` skip (``:277-279``)
  * EOS completion with ``len(sentence)**len_norm_f`` length
    normalization (``:283-287``)
  * fall back to partial (un-normalized) captions when nothing
    completed (``:295-299``)
  * greedy's temperature sharpening ``p^(1/t)/Σ`` before argmax
    (``:184-189``) is an argmax no-op for t > 0, so greedy is argmax;
    'sample' draws from ``softmax(logits / temperature)`` (``:136-138``).

``step_fn(carry, tokens[N]) -> (carry, logits[N, V])`` abstracts the
model; carry is any PyTree with leading dim N.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from vae_captioning.ops.logits_topk import top_k_logsumexp

NEG_INF = -1.0e9
# ln(1e-12), the reference's zero-probability skip threshold
_LOG_PROB_FLOOR = -27.631021

StepFn = Callable[[Any, jax.Array], Tuple[Any, jax.Array]]


# ----------------------------------------------------------------------
# greedy / temperature sampling
# ----------------------------------------------------------------------

def sample_decode(
    step_fn: StepFn,
    init_carry: Any,
    batch_size: int,
    *,
    bos_id: int,
    eos_id: int,
    max_len: int,
    mode: str = "greedy",            # greedy | sample
    temperature: float = 1.0,
    rng: jax.Array | None = None,
    step_argmax_fn: Any = None,      # greedy fast path: (carry, toks)→(carry, next)
    step_sample_fn: Any = None,      # sample fast path: (carry, toks, rng)→(carry, next)
    early_exit: bool = True,         # stop once every lane has emitted EOS
) -> jax.Array:
    """Batched greedy/sampled decode → token ids [B, max_len]
    (EOS included; positions after EOS are PAD=0).

    ``early_exit`` wraps the scan in a while_loop that stops once no
    lane is alive — output-identical (dead lanes emit PAD either way),
    and on trained models captions EOS at ~10 of 30 steps."""
    if mode == "sample" and rng is None:
        raise ValueError("mode='sample' requires an rng")
    rng = rng if rng is not None else jax.random.PRNGKey(0)
    step_rngs = jax.random.split(rng, max_len)

    def body(state, t):
        carry, tokens, alive, out = state
        step_rng = step_rngs[t]
        if mode == "greedy" and step_argmax_fn is not None:
            carry, nxt = step_argmax_fn(carry, tokens)
        elif mode == "sample" and step_sample_fn is not None:
            carry, nxt = step_sample_fn(carry, tokens, step_rng)
        else:
            carry, logits = step_fn(carry, tokens)
            if mode == "sample":
                nxt = jax.random.categorical(step_rng, logits / temperature,
                                             axis=-1)
            else:
                nxt = jnp.argmax(logits, axis=-1)
        nxt = nxt.astype(jnp.int32)
        emitted = jnp.where(alive, nxt, 0)
        out = jax.lax.dynamic_update_index_in_dim(out, emitted, t, axis=1)
        alive = jnp.logical_and(alive, nxt != eos_id)
        return (carry, nxt, alive, out)

    tokens0 = jnp.full((batch_size,), bos_id, jnp.int32)
    alive0 = jnp.ones((batch_size,), bool)
    out0 = jnp.zeros((batch_size, max_len), jnp.int32)
    state0 = (init_carry, tokens0, alive0, out0)

    if early_exit:
        def cond(loop_state):
            t, state = loop_state
            return jnp.logical_and(t < max_len, jnp.any(state[2]))

        def while_body(loop_state):
            t, state = loop_state
            return t + 1, body(state, t)

        _, (_, _, _, out) = jax.lax.while_loop(
            cond, while_body, (jnp.asarray(0, jnp.int32), state0))
    else:
        def scan_body(state, t):
            return body(state, t), None

        (_, _, _, out), _ = jax.lax.scan(scan_body, state0,
                                         jnp.arange(max_len))
    return out  # [B, max_len]


# ----------------------------------------------------------------------
# beam search
# ----------------------------------------------------------------------

class BeamResult(NamedTuple):
    """All beams, best-first per image (a PyTree, safe across jit)."""

    tokens: jax.Array   # [B, beam, max_len] (BOS excluded, EOS included)
    scores: jax.Array   # [B, beam] (length-normalized; raw logp if partial)


def _gather_beams(tree: Any, beam_idx: jax.Array, B: int, beam: int) -> Any:
    """Reindex leading [B*beam, ...] leaves by per-image beam indices."""
    def gather(leaf):
        x = leaf.reshape(B, beam, *leaf.shape[1:])
        idx = beam_idx.reshape(B, beam, *([1] * (x.ndim - 2)))
        out = jnp.take_along_axis(x, idx.astype(jnp.int32), axis=1)
        return out.reshape(B * beam, *leaf.shape[1:])

    return jax.tree.map(gather, tree)


def beam_search(
    step_fn: StepFn,
    init_carry: Any,                 # PyTree, leading dim B
    batch_size: int,
    *,
    beam_size: int,
    bos_id: int,
    eos_id: int,
    max_len: int,
    len_norm_f: float = 0.7,
    early_exit: bool = True,             # exact bound-based termination
    step_topk_fn: Optional[Callable] = None,
) -> BeamResult:
    """Batched beam search, fully on device.

    ``init_carry`` has leading dim B; it is broadcast to B*beam lanes.
    Runs exactly ``max_len`` expansion steps (the reference's initial
    BOS step + gen_max_len-1 loop), static shapes throughout.

    The loop carries BACKPOINTERS, not sequences: per step it records
    only each alive slot's parent beam and emitted token ([B, K] each),
    and the finished pool keeps (score, step, parent) triples.  Full
    sequences are rebuilt once at the end by a reverse scan over the
    [T, B, K] histories, so no [B, K², T] candidate-sequence tensor is
    gathered per step.
    """
    B, K = batch_size, beam_size

    def broadcast(leaf):
        return jnp.repeat(leaf, K, axis=0)  # [B*K, ...], beams contiguous

    carry0 = jax.tree.map(broadcast, init_carry)
    # first expansion must come from ONE beam — others start at -inf
    alive_logp0 = jnp.tile(
        jnp.asarray([0.0] + [NEG_INF] * (K - 1), jnp.float32), (B, 1))
    fin_scores0 = jnp.full((B, K), NEG_INF, jnp.float32)
    fin_step0 = jnp.full((B, K), -1, jnp.int32)      # -1 = empty slot
    fin_parent0 = jnp.zeros((B, K), jnp.int32)
    tokens0 = jnp.full((B, K), bos_id, jnp.int32)

    # candidate c in [0, K²) extends alive beam c // K (beam-major layout)
    cand_parent_row = jnp.broadcast_to(
        (jnp.arange(K * K, dtype=jnp.int32) // K)[None, :], (B, K * K))

    def body(state, t):
        carry, tokens, alive_logp, fin_scores, fin_step, fin_parent = state

        # reference semantics (decoder.py:268-291): each beam expands only
        # its OWN top-K tokens, then all K² candidates merge.  (The common
        # global top-2K shortcut admits EOS completions the reference
        # would never see.)
        #
        # Top-K + logsumexp: top-K indices over raw logits equal those
        # over log-probs, so only the K winners are normalized — never
        # materializing log_softmax over V.  A ``step_topk_fn`` (logits
        # head + top-K + lse in one call, see ops/logits_topk.py) also
        # keeps the logits out of device memory.
        if step_topk_fn is not None:
            carry, vals, toks, lse = step_topk_fn(carry,
                                                  tokens.reshape(B * K))
        else:
            carry, logits = step_fn(carry, tokens.reshape(B * K))
            vals, toks, lse = top_k_logsumexp(logits.astype(jnp.float32), K)
        logp_top = vals - lse[:, None]                           # [B·K, K]
        logp_top = jnp.where(logp_top < _LOG_PROB_FLOOR, NEG_INF,
                             logp_top)                           # p<1e-12 skip
        cand = alive_logp[:, :, None] + logp_top.reshape(B, K, K)
        top_logp = cand.reshape(B, K * K)                        # [B, K²]
        token_idx = toks.reshape(B, K * K).astype(jnp.int32)

        is_eos = token_idx == eos_id

        # ---- finished pool: normalized score, merged topk (ref :283-291).
        # Candidates whose log-prob was floored to NEG_INF (the p<1e-12
        # skip, or continuations of dead beams) must NOT become
        # completions: dividing NEG_INF by the length normalizer would
        # otherwise lift them above the has_finished threshold.
        viable = jnp.logical_and(is_eos, top_logp > NEG_INF / 2)
        sent_len = (t + 2).astype(jnp.float32)  # BOS + t+1 emitted tokens
        norm = jnp.where(len_norm_f > 0, sent_len ** len_norm_f, 1.0)
        eos_scores = jnp.where(viable, top_logp / norm, NEG_INF)  # [B, K²]
        all_scores = jnp.concatenate([fin_scores, eos_scores], axis=1)
        new_fin_scores, keep = jax.lax.top_k(all_scores, K)      # [B, K]
        all_step = jnp.concatenate(
            [fin_step, jnp.full((B, K * K), 1, jnp.int32)
             * t.astype(jnp.int32)], axis=1)
        all_parent = jnp.concatenate([fin_parent, cand_parent_row], axis=1)
        new_fin_step = jnp.take_along_axis(all_step, keep, axis=1)
        new_fin_parent = jnp.take_along_axis(all_parent, keep, axis=1)

        # ---- alive pool: best K non-EOS continuations
        alive_cand = jnp.where(is_eos, NEG_INF, top_logp)
        new_alive_logp, alive_keep = jax.lax.top_k(alive_cand, K)  # [B, K]
        new_tokens = jnp.take_along_axis(token_idx, alive_keep, axis=1)
        parent_of_alive = alive_keep // K   # beam-major candidate layout
        carry = _gather_beams(carry, parent_of_alive, B, K)

        return (carry, new_tokens, new_alive_logp, new_fin_scores,
                new_fin_step, new_fin_parent), (parent_of_alive, new_tokens)

    state0 = (carry0, tokens0, alive_logp0, fin_scores0, fin_step0,
              fin_parent0)

    if early_exit:
        # Exact early termination: log-probs only decrease, and the most
        # favorable future length normalizer is max_len, so the best any
        # alive beam can still score is max(alive_logp)/norm(max_len).
        # Once that bound is below every image's worst KEPT finished
        # score, further steps cannot change the result.
        final_norm = (float(max_len + 1) ** len_norm_f
                      if len_norm_f > 0 else 1.0)

        def cond(loop_state):
            t, state, _, _ = loop_state
            alive_logp, fin_scores = state[2], state[3]
            best_possible = jnp.max(alive_logp, axis=1) / final_norm
            worst_kept = jnp.min(fin_scores, axis=1)
            can_improve = best_possible > worst_kept
            return jnp.logical_and(t < max_len, jnp.any(can_improve))

        def while_body(loop_state):
            t, state, bp_hist, tok_hist = loop_state
            state, (bp_t, tok_t) = body(state, t)
            bp_hist = jax.lax.dynamic_update_index_in_dim(
                bp_hist, bp_t, t, axis=0)
            tok_hist = jax.lax.dynamic_update_index_in_dim(
                tok_hist, tok_t, t, axis=0)
            return t + 1, state, bp_hist, tok_hist

        t_stop, state, bp_hist, tok_hist = jax.lax.while_loop(
            cond, while_body,
            (jnp.asarray(0, jnp.int32), state0,
             jnp.zeros((max_len, B, K), jnp.int32),
             jnp.zeros((max_len, B, K), jnp.int32)))
    else:
        state, (bp_hist, tok_hist) = jax.lax.scan(
            body, state0, jnp.arange(max_len))
        t_stop = jnp.asarray(max_len, jnp.int32)

    _, _, alive_logp, fin_scores, fin_step, fin_parent = state

    # fallback to partials when nothing completed (ref :295-299): partial
    # captions keep their raw log-prob as score
    has_finished = jnp.any(fin_scores > NEG_INF / 2, axis=1, keepdims=True)
    out_scores = jnp.where(has_finished, fin_scores, alive_logp)

    # Each output row is (step_e, parent_e, is_fin): a finished entry
    # emits EOS at position step_e and backtraces from (step_e-1,
    # parent_e); an alive partial is the same with step_e = t_stop and no
    # EOS.  Empty fin slots have step_e = -1 → all-PAD rows.
    slot_id = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32)[None, :],
                               (B, K))
    step_e = jnp.where(has_finished, fin_step, t_stop)
    parent_e = jnp.where(has_finished, fin_parent, slot_id)
    emit_eos = jnp.broadcast_to(has_finished, (B, K))

    # reverse scan: walk s = T-1 … 0, following parent pointers once
    # s drops below step_e
    def back(ptr, inp):
        s, bp_s, tok_s = inp
        active = s < step_e                                    # [B, K]
        tok = jnp.take_along_axis(tok_s, ptr, axis=1)
        out = jnp.where(active, tok, 0)
        out = jnp.where(jnp.logical_and(s == step_e, emit_eos), eos_id, out)
        nxt = jnp.take_along_axis(bp_s, ptr, axis=1)
        ptr = jnp.where(active, nxt, ptr)
        return ptr, out

    steps_rev = jnp.arange(max_len - 1, -1, -1, dtype=jnp.int32)
    _, out_rev = jax.lax.scan(
        back, parent_e, (steps_rev, bp_hist[::-1], tok_hist[::-1]))
    out_seq = jnp.transpose(out_rev[::-1], (1, 2, 0))          # [B, K, T]

    # best-first order per image
    order = jnp.argsort(-out_scores, axis=1)
    out_scores = jnp.take_along_axis(out_scores, order, axis=1)
    out_seq = jnp.take_along_axis(out_seq, order[:, :, None], axis=1)
    return BeamResult(tokens=out_seq, scores=out_scores)


def tokens_to_text(token_row, idx2word, eos_id: int,
                   bos_id: Optional[int] = None) -> str:
    """Host-side: one token row → caption string.

    Stops at EOS, drops PAD and (when given) BOS — sample-mode decoding
    can emit BOS mid-sequence and the reference filters it from the
    joined text (decoder.py:198-199).  <UNK> is kept, as the reference
    keeps it."""
    words = []
    for tok in token_row:
        tok = int(tok)
        if tok == eos_id:
            break
        if tok == 0 or (bos_id is not None and tok == bos_id):
            continue
        words.append(idx2word[tok])
    return " ".join(words)
