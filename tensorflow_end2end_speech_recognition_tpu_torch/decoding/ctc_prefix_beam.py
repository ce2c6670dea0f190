"""Batched CTC prefix beam search on the device of the logits.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/decoding/
ctc_prefix_beam.py``, with the same split into ``beam_init``,
``beam_advance`` and ``beam_finalize`` (streaming drives ``beam_advance``
chunk by chunk). The beam is a fixed-width tensor program over frames. Per
frame every live prefix makes a **stay** candidate (it absorbs a blank, or
repeats its last class) and K **extend** candidates (one of the frame's
top-K non-blank classes), N = W·(K+1) in all. Prefixes are identified by
two 32-bit rolling hashes; candidates with the same prefix are merged by an
O(N²) equality-masked logsumexp that keeps the first occurrence, and the
best W by combined (blank + non-blank) mass survive. Rows freeze past their
``valid_len``, so chunk boundaries do not change the result.

The JAX hashes are uint32, whose arithmetic PyTorch lacks; here they are
int64 holding values in [0, 2³²), and ``h·M + c + 1 mod 2³²`` is formed from
M's 16-bit halves so that no product overflows. Ties break as
``lax.top_k`` and ``jnp.argsort`` break them, the lower index first (stable
sorts), and the -1e30 arithmetic of dead candidates is the JAX module's.
The frame loop reads nothing back to the host, so it can be captured in
one CUDA graph. The per-frame top-K of the log-probabilities is one sort
over all frames before the loop.

Shallow fusion adds ``lm_weight · logp_lm(c | prefix)`` to extensions,
through ``fusion_lm`` (a ``FusionLM`` whose state rides the beam slots and
advances once per accepted extension, ``models/lm.make_fusion_lm``) or the
stateless ``lm_logp_fn`` (every prefix rescored from scratch each frame,
``models/lm.lm_prefix_logp``).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

_NEG = -1e30
_MASK32 = 0xFFFFFFFF
_H1_MULT = 2654435761  # Knuth multiplicative
_H2_MULT = 40503


class FusionLM(NamedTuple):
    """Carried-state LM for shallow fusion inside the beam.

    ``init(b, w) -> (state, logp [B, W, C])``: per-slot state after
    ``<sos>`` and the next-token distribution on the CTC classes (the blank
    column is never read). ``step(state, tokens [B, W]) -> (state, logp)``
    advances every slot by one token. State leaves are [B, W, ...].
    """

    init: Callable[[int, int], tuple[Any, torch.Tensor]]
    step: Callable[[Any, torch.Tensor], tuple[Any, torch.Tensor]]


class BeamState(NamedTuple):
    prefixes: torch.Tensor  # [B, W, L] int32, -1 padded
    lengths: torch.Tensor  # [B, W] int32
    last: torch.Tensor  # [B, W] int32 last class (-1 if empty)
    h1: torch.Tensor  # [B, W] int64 in [0, 2^32): rolling hash 1
    h2: torch.Tensor  # [B, W] int64 in [0, 2^32): rolling hash 2
    pb: torch.Tensor  # [B, W] log prob ending in blank
    pnb: torch.Tensor  # [B, W] log prob ending in non-blank
    lm_score: torch.Tensor  # [B, W] accumulated LM log prob (0 without an LM)
    lm_state: Any = None  # carried FusionLM state (leaves [B, W, ...])
    lm_logp: torch.Tensor | None = None  # cached next-token logp [B, W, C]


def tree_map(fn, *trees):
    """``fn`` over the tensors of nested NamedTuples, tuples, lists and dicts
    (``None`` stays ``None``): the beams' and the streams' state trees."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def hash_step(h: torch.Tensor, c: torch.Tensor, mult: int) -> torch.Tensor:
    """``(h · mult + c + 1) mod 2³²`` on int64 values in [0, 2³²), exactly:
    each product of ``h`` with a 16-bit half of ``mult`` stays below 2⁴⁸."""
    lo, hi = mult & 0xFFFF, mult >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16) + c + 1) & _MASK32


def beam_init(b: int, beam_width: int, max_prefix_len: int,
              fusion_lm: FusionLM | None = None, lm_weight: float = 0.0,
              device=None) -> BeamState:
    """Fresh beam state: the empty prefix live in slot 0.

    Dead slots 1..W-1 get distinct sentinel hashes, so they never merge with
    the live empty prefix (a surviving duplicate would double-count its mass
    on later frames).
    """
    w = beam_width
    slot = torch.arange(w, dtype=torch.int64, device=device)
    sent1 = torch.where(slot == 0, 0, 0x80000000 + slot).expand(b, w).contiguous()
    sent2 = torch.where(slot == 0, 0, 0xC0000000 + slot).expand(b, w).contiguous()
    use_fusion = fusion_lm is not None and lm_weight
    lm_state0, lm_logp0 = fusion_lm.init(b, w) if use_fusion else (None, None)
    pb = torch.full((b, w), _NEG, dtype=torch.float32, device=device)
    pb[:, 0] = 0.0
    return BeamState(
        prefixes=torch.full((b, w, max_prefix_len), -1, dtype=torch.int32, device=device),
        lengths=torch.zeros((b, w), dtype=torch.int32, device=device),
        last=torch.full((b, w), -1, dtype=torch.int32, device=device),
        h1=sent1, h2=sent2, pb=pb,
        pnb=torch.full((b, w), _NEG, dtype=torch.float32, device=device),
        lm_score=torch.zeros((b, w), dtype=torch.float32, device=device),
        lm_state=lm_state0, lm_logp=lm_logp0,
    )


def beam_finalize(state: BeamState, lm_weight: float = 0.0):
    """(prefixes [B, W, L], lengths [B, W], scores [B, W]), best first."""
    scores = torch.logaddexp(state.pb, state.pnb) + lm_weight * state.lm_score
    order = torch.argsort(-scores, dim=1, stable=True)
    return (state.prefixes.gather(1, order[..., None].expand_as(state.prefixes)),
            state.lengths.gather(1, order), scores.gather(1, order))


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the lower index first among ties."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def beam_advance(state: BeamState, logits: torch.Tensor, valid_len: torch.Tensor,
                 blank_id: int, top_k_classes: int | None = None, lm_logp_fn=None,
                 lm_weight: float = 0.0, fusion_lm: FusionLM | None = None) -> BeamState:
    """Advance the beam over a chunk of frames ``logits`` [B, Tc, C]; row b
    consumes its first ``valid_len[b]`` frames and keeps its state after."""
    b, t, c = logits.shape
    w = state.pb.shape[1]
    k = min(top_k_classes or 16, c - 1)
    l_max = state.prefixes.shape[2]
    n = w + w * k
    dev = logits.device
    use_fusion = fusion_lm is not None and lm_weight
    use_hook = not use_fusion and lm_logp_fn is not None and lm_weight

    log_probs = torch.log_softmax(logits.float(), dim=-1)
    lp_blank_all = log_probs[:, :, blank_id]  # [B, T]
    lp_nb = log_probs.clone()
    lp_nb[:, :, blank_id] = _NEG
    top_lp_all, top_idx_all = _top_k(lp_nb, k)  # [B, T, K], every frame at once
    top_idx_all = top_idx_all.to(torch.int32)
    valid_len = valid_len.to(dev)

    cand_parent = torch.cat([torch.arange(w, device=dev),
                             torch.arange(w, device=dev).repeat_interleave(k)])  # [N]
    cand_parent = cand_parent.expand(b, n)
    earlier = torch.ones((n, n), dtype=torch.bool, device=dev).tril(-1)  # j < i
    pos = torch.arange(l_max, device=dev)
    stay_char = torch.full((b, w), -1, dtype=torch.int32, device=dev)
    no_pb = torch.full((b, w * k), _NEG, device=dev)
    no_lm = torch.zeros((b, w, k), device=dev)

    for ti in range(t):
        lp = log_probs[:, ti]  # [B, C]
        lp_blank = lp_blank_all[:, ti]
        top_lp, top_idx = top_lp_all[:, ti], top_idx_all[:, ti]

        # ---- stay candidates (W) --------------------------------------------
        stay_pb = torch.logaddexp(state.pb, state.pnb) + lp_blank[:, None]
        lp_last = lp.gather(1, state.last.clamp_min(0).long())
        stay_pnb = torch.where(state.last >= 0, state.pnb + lp_last, _NEG)

        # ---- extension candidates (W·K): parent w extended with top_idx[b, j]
        ext_c = top_idx[:, None, :].expand(b, w, k)
        base = torch.where(ext_c == state.last[..., None], state.pb[..., None],
                           torch.logaddexp(state.pb, state.pnb)[..., None])
        ext_pnb = base + top_lp[:, None, :]
        # dead parents spawn nothing, and full prefixes cannot extend
        blocked = (torch.maximum(state.pb, state.pnb) <= _NEG / 2) | (state.lengths >= l_max)
        ext_pnb = torch.where(blocked[..., None], _NEG, ext_pnb)
        if use_fusion:  # the next-token distribution is cached per slot
            ext_lm = state.lm_logp.gather(2, ext_c.long())
        elif use_hook:
            ext_lm = lm_logp_fn(state.prefixes, state.lengths).gather(2, ext_c.long())
        else:
            ext_lm = no_lm
        ext_h1 = hash_step(state.h1[..., None], ext_c, _H1_MULT)
        ext_h2 = hash_step(state.h2[..., None], ext_c, _H2_MULT)

        # ---- candidate sets [B, N] ------------------------------------------
        cand_pb = torch.cat([stay_pb, no_pb], dim=1)
        cand_pnb = torch.cat([stay_pnb, ext_pnb.reshape(b, w * k)], dim=1)
        cand_h1 = torch.cat([state.h1, ext_h1.reshape(b, w * k)], dim=1)
        cand_h2 = torch.cat([state.h2, ext_h2.reshape(b, w * k)], dim=1)
        cand_char = torch.cat([stay_char, ext_c.reshape(b, w * k)], dim=1)
        cand_lm = torch.cat([state.lm_score, (state.lm_score[..., None] + ext_lm)
                             .reshape(b, w * k)], dim=1)

        # ---- merge candidates with the same prefix -------------------------
        # one int64 key per hash pair: (h1 - 2^31) · 2^32 + h2 is a bijection
        # into int64 and cannot overflow
        key = (cand_h1 - 0x80000000) * 0x100000000 + cand_h2
        same = key[:, :, None] == key[:, None, :]  # [B, N, N]
        v = torch.stack([cand_pb, cand_pnb], dim=1)  # [B, 2, N]
        vm = torch.where(same[:, None], v[:, :, None, :], _NEG)  # row i gathers dups j
        m = vm.amax(dim=-1)
        lse = m + torch.log(torch.exp(vm - m[..., None]).sum(dim=-1))
        # keep the first occurrence only: a duplicate that kept its mass and
        # survived selection would re-merge it every later frame
        is_first = ~(same & earlier).any(dim=-1)
        merged = torch.where(is_first[:, None], lse, _NEG)
        merged_pb, merged_pnb = merged[:, 0], merged[:, 1]
        total = torch.logaddexp(merged_pb, merged_pnb) + lm_weight * cand_lm
        total = torch.where(is_first, total, _NEG)

        # ---- select the best W ----------------------------------------------
        _, sel = _top_k(total, w)  # [B, W]
        sel_parent = cand_parent.gather(1, sel)
        sel_char = cand_char.gather(1, sel)
        new_prefixes = state.prefixes.gather(1, sel_parent[..., None].expand(b, w, l_max))
        new_len = state.lengths.gather(1, sel_parent)
        # a starved beam can select a masked extension of a full prefix: its
        # class is not written (no position l_max), so its length stays too
        is_ext = (sel_char >= 0) & (new_len < l_max)
        write = (pos == new_len[..., None]) & is_ext[..., None]
        new_prefixes = torch.where(write, sel_char[..., None], new_prefixes)
        new_lm_state, new_lm_logp = state.lm_state, state.lm_logp
        if use_fusion:  # advance the LM once per accepted extension
            def pgather(x):
                idx = sel_parent.reshape((b, w) + (1,) * (x.dim() - 2)).expand_as(x)
                return x.gather(1, idx)

            par_state = tree_map(pgather, state.lm_state)
            par_logp = pgather(state.lm_logp)
            adv_state, adv_logp = fusion_lm.step(par_state, torch.where(is_ext, sel_char, 0))

            def pick(new, old):
                return torch.where(is_ext.reshape((b, w) + (1,) * (new.dim() - 2)), new, old)

            new_lm_state = tree_map(pick, adv_state, par_state)
            new_lm_logp = torch.where(is_ext[..., None], adv_logp, par_logp)
        new_state = BeamState(
            prefixes=new_prefixes,
            lengths=new_len + is_ext.to(torch.int32),
            last=torch.where(is_ext, sel_char, state.last.gather(1, sel_parent)),
            h1=cand_h1.gather(1, sel), h2=cand_h2.gather(1, sel),
            pb=merged_pb.gather(1, sel), pnb=merged_pnb.gather(1, sel),
            lm_score=cand_lm.gather(1, sel),
            lm_state=new_lm_state, lm_logp=new_lm_logp,
        )
        # frames past valid_len carry the state unchanged
        active = ti < valid_len

        def keep_active(new, old):
            return torch.where(active.reshape((b,) + (1,) * (new.dim() - 1)), new, old)

        state = BeamState(*(tree_map(keep_active, x, y) for x, y in zip(new_state, state)))
    return state


def ctc_prefix_beam_search(logits: torch.Tensor, logit_len: torch.Tensor, blank_id: int,
                           beam_width: int = 20, top_k_classes: int | None = None,
                           max_prefix_len: int | None = None, lm_logp_fn=None,
                           lm_weight: float = 0.0, fusion_lm: FusionLM | None = None):
    """(prefixes [B, W, L] int32, lengths [B, W] int32, scores [B, W]), best first.

    Scores are total log probabilities log(p_blank + p_nonblank), plus the
    weighted LM score when fusion is on. ``lm_logp_fn(prefixes [B, W, L],
    lengths [B, W]) -> logp [B, W, C]`` is the stateless LM hook;
    ``fusion_lm`` (preferred) carries the LM state per slot.
    """
    b, t, _ = logits.shape
    state = beam_init(b, beam_width, max_prefix_len or t, fusion_lm, lm_weight, logits.device)
    state = beam_advance(state, logits, logit_len, blank_id, top_k_classes, lm_logp_fn,
                         lm_weight, fusion_lm)
    return beam_finalize(state, lm_weight)
