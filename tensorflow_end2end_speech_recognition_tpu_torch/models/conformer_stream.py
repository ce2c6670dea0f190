"""Chunked (streaming) execution of chunk-causal conformer / transformer stacks.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/models/
conformer_stream.py``. The offline stack with ``left_context >= 0``
(``models/conformer.py``) is causal: each query sees itself and L past
frames, and the depthwise conv is padded on the left. This module runs the
same arithmetic one chunk at a time with a bounded per-layer cache, so the
chunked outputs equal the offline ones:

- **KV cache** per layer: the last L keys and values ([B, L, d] each,
  right-aligned). Keys are cached after the rotary rotation, whose angle
  depends only on the key's own global position.
- **Conv cache** per layer (conformer blocks): the last k-1 inputs of the
  depthwise conv (after the GLU), [B, k-1, d]; zeros at the start, as the
  offline conv's left padding.
- **Global offset** ``enc_seen`` [B]: frames already consumed per row, so
  sinusoids and rotary angles are taken at the true stream positions.

Rows are independent: each step takes xs [B, F, D] with per-row valid
counts ``n_new`` [B]; positions past ``n_new`` never enter a cache or a
valid query's window, and a row with ``n_new == 0`` keeps its cache bit for
bit (every update is a per-row shift by ``n_new``). Scores are masked with
-1e30 twice, keys then the window, as the offline ``MHSA`` masks them; the
conv is one grouped ``F.conv1d`` over ``[cache, chunk]``. At
``compute_dtype: bfloat16`` the products take the JAX chunk step's ``dt``
casts: the ``Dense`` layers (Q, K, V, the output, the conv module's
pointwise layers, the feed-forwards) and the score and context products on
bf16 operands with float32 sums (``ops/bf16``); everything else float32.
``pos_encoding="relative"`` is refused by ``streaming._validate``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops import bf16 as bf16_ops
from .conformer import MASK_FILL, Conformer, ConformerSpec, rope_at, sinusoids


def conformer_cache_init(spec: ConformerSpec, batch_size: int, device=None):
    """The zeroed stream cache: ``(enc_seen [B], per layer (k, v[, conv]))``."""
    if spec.left_context < 0:
        raise ValueError("streaming a conformer/transformer needs left_context >= 0 "
                         "(the bidirectional stack has an unbounded window)")
    b, d, L = batch_size, spec.dim, spec.left_context

    def zeros(n):
        return torch.zeros((b, n, d), dtype=torch.float32, device=device)

    layers = []
    for _ in range(spec.num_layers):
        kv = (zeros(L), zeros(L))
        layers.append(kv if spec.block == "transformer"
                      else kv + (zeros(spec.conv_kernel_size - 1),))
    return torch.zeros((b,), dtype=torch.int64, device=device), tuple(layers)


def shift_in(cache: torch.Tensor, new: torch.Tensor, n_new: torch.Tensor) -> torch.Tensor:
    """Row b: the last W entries of ``cat(cache[b], new[b, :n_new[b]])``, right-aligned.

    cache [B, W, d], new [B, F, d] (positions past ``n_new`` are never
    selected), n_new [B] -> [B, W, d].
    """
    w = cache.shape[1]
    buf = torch.cat([cache, new], dim=1)
    src = (torch.arange(w, device=cache.device)[None, :] + n_new[:, None]).clamp(
        0, buf.shape[1] - 1)
    return buf.gather(1, src[..., None].expand(-1, -1, buf.shape[2]))


def _stream_attend(mhsa, x, spec: ConformerSpec, kc, vc, enc_seen, n_new):
    """One MHSA over [cache, chunk] keys: (out, new k cache, new v cache)."""
    b, f, d = x.shape
    h = spec.num_heads
    dh = d // h
    L = spec.left_context
    dev = x.device
    y = mhsa.ln(x)
    q, k, v = mhsa.q(y), mhsa.k(y), mhsa.v(y)
    gpos = enc_seen[:, None] + torch.arange(f, device=dev)[None, :]  # [B, F] global

    def heads(z, t):
        return z.reshape(b, t, h, dh).transpose(1, 2)

    qh, kh = heads(q, f), heads(k, f)
    if spec.pos_encoding == "rotary":
        qh, kh = rope_at(qh, gpos), rope_at(kh, gpos)
    # garbage chunk positions are zeroed before caching (and masked below)
    chunk_ok = (torch.arange(f, device=dev)[None, :] < n_new[:, None])[..., None]
    k_flat = kh.transpose(1, 2).reshape(b, f, d) * chunk_ok
    v_flat = v * chunk_ok
    new_kc, new_vc = shift_in(kc, k_flat, n_new), shift_in(vc, v_flat, n_new)

    kh_all = heads(torch.cat([kc, k_flat], dim=1), L + f)
    vh_all = heads(torch.cat([vc, v_flat], dim=1), L + f)
    scores = bf16_ops.linear(qh, kh_all.transpose(-1, -2), spec.bf16) / math.sqrt(dh)
    # key position relative to the chunk start: cache keys -L..-1, chunk keys 0..F-1
    rel = torch.arange(L + f, device=dev)[None, :] - L
    cache_len = enc_seen.clamp_max(L)
    key_ok = torch.where(rel < 0, rel >= -cache_len[:, None], rel < n_new[:, None])  # [B, L+F]
    dist = torch.arange(f, device=dev)[:, None] - rel  # [F, L+F]
    win = (dist >= 0) & (dist <= L)
    scores = torch.where(key_ok[:, None, None, :], scores, MASK_FILL)
    scores = torch.where(win[None, None], scores, MASK_FILL)
    out = bf16_ops.linear(torch.softmax(scores, dim=-1), vh_all, spec.bf16)
    return mhsa.o(out.transpose(1, 2).reshape(b, f, d)), new_kc, new_vc


def _stream_conv(conv, x, yc, n_new):
    """The causal conv module over [cache, chunk]: (out, new conv cache)."""
    f, d = x.shape[1], x.shape[2]
    a, g = conv.pw1(conv.ln(x)).chunk(2, dim=-1)
    y = a * torch.sigmoid(g) * (torch.arange(f, device=x.device)[None, :]
                                < n_new[:, None])[..., None]
    new_yc = shift_in(yc, y, n_new)
    buf = torch.cat([yc, y], dim=1).transpose(1, 2)  # [B, d, k-1+F]
    out = F.conv1d(buf, conv.dw.permute(2, 1, 0), groups=d).transpose(1, 2)  # [B, F, d]
    return conv.pw2(F.silu(conv.norm(out))), new_yc


def conformer_stream_step(conformer: Conformer, cache, xs: torch.Tensor, n_new: torch.Tensor):
    """One chunk through the stack: ``(cache, xs [B, F, D], n_new [B]) ->
    (outputs [B, F, dim], new cache)``. Positions at or past ``n_new[b]`` are
    garbage in and zero out; the caller masks by ``n_new`` as the offline
    callers mask by lengths."""
    spec = conformer.spec
    enc_seen, layer_caches = cache
    f = xs.shape[1]
    n_new = n_new.to(xs.device)
    mask = torch.arange(f, device=xs.device)[None, :] < n_new[:, None]
    x = conformer.proj(xs)
    if spec.pos_encoding == "absolute":
        x = x + sinusoids(enc_seen[:, None] + torch.arange(f, device=xs.device)[None, :],
                          spec.dim)
    x = x * mask[..., None]
    new_caches = []
    for p, layer_cache in zip(conformer.layers, layer_caches):
        if spec.block == "transformer":
            kc, vc = layer_cache
            a, nkc, nvc = _stream_attend(p.mhsa, x, spec, kc, vc, enc_seen, n_new)
            x = x + a
            x = x + (p.moe(x, mask)[0] if spec.is_moe else p.ff(x))
            new_caches.append((nkc, nvc))
        else:
            kc, vc, yc = layer_cache
            x = x + 0.5 * p.ff1(x)
            a, nkc, nvc = _stream_attend(p.mhsa, x, spec, kc, vc, enc_seen, n_new)
            x = x + a
            c, nyc = _stream_conv(p.conv, x, yc, n_new)
            x = x + c
            x = x + 0.5 * (p.moe(x, mask)[0] if spec.is_moe else p.ff2(x))
            x = p.ln(x)
            new_caches.append((nkc, nvc, nyc))
    if spec.block == "transformer":
        x = conformer.ln_out(x)
    return x * mask[..., None], (enc_seen + n_new, tuple(new_caches))
