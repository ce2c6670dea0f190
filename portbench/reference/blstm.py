"""Plain bidirectional LSTM layers, the recipe of the configuration's compute type.

One layer, per direction: ``xproj = Q(Q(x) @ Q(Wx) + b)``, then the walk
``gates = xproj[t] + h[t-1] @ Wh`` (gates i, f, g, o; 1.0 added to f) with
``h``, ``c`` and ``Wh`` float32; a step past a row's length carries h and c
and emits 0; the emitted ``ys`` and the cell states ``cs`` are stored
rounded (``Q``). The backward direction runs over each row's valid prefix
reversed. The walk's gradient is the reference's recipe for these layers:
each step's gates are recomputed from the stored ``ys[t-1]`` and ``cs``,
``dh = dgates @ Wh^T`` is carried in float32, the emitted ``dxproj`` is
rounded, and ``dWh = Σ_t ys[t-1]^T dxproj[t]``. At float32 that is exact
autograd of the walk; at bfloat16 the stored streams are bf16.
"""

from __future__ import annotations

import torch

FORGET_BIAS = 1.0


def flip_valid(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """[B, T, ...]: each row's first ``lengths`` steps reversed, the rest kept."""
    t = x.shape[1]
    idx = torch.arange(t, device=x.device)[None, :]
    n = lengths.to(x.device)[:, None]
    src = torch.where(idx < n, n - 1 - idx, idx)
    return x.gather(1, src.reshape(*src.shape, *(1,) * (x.dim() - 2)).expand_as(x))


class Walk(torch.autograd.Function):
    """Both directions at once: ``xproj`` [2, B, T, 4H] (values on the
    compute type's grid), ``wh`` [2, H, 4H], ``mask`` [B, T] -> ``ys``
    [2, B, T, H], the backward direction in its reversed order."""

    @staticmethod
    def forward(ctx, xproj, wh, mask, q):
        _, b, t, g4 = xproj.shape
        h_dim = g4 // 4
        h = xproj.new_zeros((2, b, h_dim))
        c = xproj.new_zeros((2, b, h_dim))
        hs, cs = [], []
        for s in range(t):
            gates = xproj[:, :, s] + torch.bmm(h, wh)
            i, f, g, o = gates.split(h_dim, dim=-1)
            c_new = torch.sigmoid(f + FORGET_BIAS) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            on = mask[None, :, s, None] > 0
            h = torch.where(on, h_new, h)
            c = torch.where(on, c_new, c)
            hs.append(h * mask[None, :, s, None])
            cs.append(c)
        ys = q.value(torch.stack(hs, 2))
        cs = q.value(torch.stack(cs, 2))
        ctx.save_for_backward(xproj, wh, mask, ys, cs)
        ctx.q = q
        return ys

    @staticmethod
    def backward(ctx, gys):
        xproj, wh, mask, ys, cs = ctx.saved_tensors
        q = ctx.q
        gys = q.value(gys)
        _, b, t, g4 = xproj.shape
        h_dim = g4 // 4
        zero = xproj.new_zeros((2, b, 1, h_dim))
        h_prev = torch.cat([zero, ys[:, :, :-1]], 2)
        c_prev = torch.cat([zero, cs[:, :, :-1]], 2)
        wht = wh.transpose(1, 2)
        dh = xproj.new_zeros((2, b, h_dim))
        dc = xproj.new_zeros((2, b, h_dim))
        dx = [None] * t
        for s in reversed(range(t)):
            on = mask[None, :, s, None] > 0
            gates = xproj[:, :, s] + torch.bmm(h_prev[:, :, s], wh)
            i, f, g, o = gates.split(h_dim, dim=-1)
            i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f + FORGET_BIAS), torch.tanh(g),
                          torch.sigmoid(o))
            dh_total = torch.where(on, gys[:, :, s], 0.0) + dh
            tc = torch.tanh(cs[:, :, s])
            dc_total = dc + dh_total * o * (1.0 - tc * tc)
            dgates = torch.cat([dc_total * g * i * (1.0 - i),
                                dc_total * c_prev[:, :, s] * f * (1.0 - f),
                                dc_total * i * (1.0 - g * g),
                                dh_total * tc * o * (1.0 - o)], -1)
            dgates = torch.where(on, dgates, 0.0)
            dx[s] = dgates
            dh = torch.where(on, torch.bmm(dgates, wht), dh_total)
            dc = torch.where(on, dc_total * f, dc)
        dxproj = q.value(torch.stack(dx, 2))
        dwh = torch.einsum("dbth,dbtg->dhg", h_prev, dxproj)
        return dxproj, dwh, None, None


def blstm_layer(x, lengths, p: dict, prefix: str, q):
    """[B, T, D] -> [B, T, 2H] (forward ++ backward), on the grid of ``q``."""
    mask = (torch.arange(x.shape[1], device=x.device)[None, :]
            < lengths.to(x.device)[:, None]).to(torch.float32)
    xq = q(x)
    proj = []
    for d in ("fwd", "bwd"):
        y = q(xq @ q(p[f"{prefix}.{d}.wx"]) + p[f"{prefix}.{d}.b"])
        proj.append(y if d == "fwd" else flip_valid(y, lengths))
    wh = torch.stack([p[f"{prefix}.fwd.wh"], p[f"{prefix}.bwd.wh"]])
    ys = Walk.apply(torch.stack(proj), wh, mask, q)
    return torch.cat([ys[0], flip_valid(ys[1], lengths)], -1)


def dropout(x, keep: torch.Tensor | None, keep_prob: float, q):
    """Inverted dropout with a drawn ``keep`` mask (None: identity), the
    scaled value stored in the compute type."""
    if keep is None:
        return x
    return q(torch.where(keep, x / keep_prob, 0.0))


def draw_keep(shape, keep_prob: float, generator) -> torch.Tensor | None:
    """One dropout mask: a uniform draw below ``keep_prob`` per element, from
    ``generator`` on the card (the step's draw, made again from its seed)."""
    if keep_prob >= 1.0 or generator is None:
        return None
    return torch.rand(shape, generator=generator, device=generator.device) < keep_prob


def pyramid(x, lengths):
    """Adjacent frame pairs concatenated: [B, T, H] -> [B, ceil(T/2), 2H],
    lengths ceil(len / 2), frames past them zeroed."""
    b, t, h = x.shape
    if t % 2:
        x = torch.nn.functional.pad(x, (0, 0, 0, 1))
        t += 1
    out = x.reshape(b, t // 2, 2 * h)
    new_len = (lengths + 1) // 2
    valid = (torch.arange(t // 2, device=x.device)[None, :] < new_len.to(x.device)[:, None])
    return out * valid[..., None], new_len


def encoder(feats, lengths, p: dict, exp: dict, q, generator=None):
    """The BLSTM stack (pyramidal when the config says so), dropout after
    every layer in training (``generator`` given)."""
    x = feats
    levels = exp.get("num_pyramid_levels")
    pyramidal = exp["encoder_type"] in ("pyramidal_blstm", "pblstm")
    if pyramidal and levels is None:
        levels = exp["num_layers"] - 1
    for layer in range(exp["num_layers"]):
        x = blstm_layer(x, lengths, p, f"encoder.layers.{layer}", q)
        x = dropout(x, draw_keep(x.shape, exp.get("dropout", 1.0), generator),
                    exp.get("dropout", 1.0), q)
        if pyramidal and layer < levels:
            x, lengths = pyramid(x, lengths)
    return x, lengths
