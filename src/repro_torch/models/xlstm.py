"""xLSTM blocks (sLSTM + mLSTM, arXiv:2405.04517).

The counterpart of the reference's ``repro.models.xlstm``, with its
adaptation: the paper's exponential input gate is a sigmoid (log-gate
<= 0), which removes the running-max stabilizer state.

* **mLSTM** — matrix memory per head, ``C_t = f_t C_{t-1} + i_t v_t k_t^T``,
  normalizer ``n_t = f_t n_{t-1} + i_t k_t``, output
  ``h_t = C_t q_t / max(|n_t . q_t|, 1)``, computed chunkwise: within a
  chunk a quadratic (c x c) product, across chunks a recurrence on the
  chunk states.  The reference scans the chunk states with ``lax.scan``;
  here it is a Python loop over the ``S / chunk`` chunks, carrying ``C``
  and ``n`` in the working dtype out of place.
* **sLSTM** — scalar memory with per-head recurrent mixing ``R h_{t-1}``,
  sequential: the reference's ``lax.scan`` over time is a Python loop that
  collects ``h`` in a list and stacks it.  Gates in float32, the states
  cast back to the working dtype every step, as there.  The loop has a
  hand-written backward (``_SLSTMScan``): autograd through it would
  record a graph node for every op of every position, and under the
  train step's ``vmap(grad)`` run each op of its backward batched through
  functorch, one position at a time.

One difference in form: the intra-chunk decay ``exp(F_t - F_s + li_s)``
is taken of ``-inf`` above the diagonal instead of being taken of the
exponent and masked after.  The forward is the same (both give 0 there),
but above the diagonal the exponent is positive and grows ~0.7 a step, so
at a chunk of 128 it passes float32's ``exp`` range and the reference's
masked gradient is ``0 * inf = nan``; this form keeps it finite.

No in-place writes on differentiated tensors and no ``assert`` on these
paths: they run under ``torch.func.vmap(grad)`` (the train step's
per-worker gradients).
Decode returns new state tensors, as the reference does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# mLSTM cell (chunkwise parallel)
# ---------------------------------------------------------------------------

def init_mlstm(gen, cfg):
    d, nh = cfg.d_model, cfg.num_heads
    dt = _dtype(cfg)
    return {
        "ln": torch.ones((d,), dtype=dt, device=gen.device),
        "w_up": L.dense_init(gen, d, 2 * d, dt),
        "wq": L.dense_init(gen, d, d, dt),
        "wk": L.dense_init(gen, d, d, dt),
        "wv": L.dense_init(gen, d, d, dt),
        "w_if": L.dense_init(gen, d, 2 * nh, dt),   # input & forget pre-gates
        "w_down": L.dense_init(gen, d, d, dt, scale=1.0 / math.sqrt(d)),
    }


def mlstm_pspecs():
    return {"ln": (None,), "w_up": ("embed", "mlp"), "wq": ("embed", "heads"),
            "wk": ("embed", "heads"), "wv": ("embed", "heads"),
            "w_if": ("embed", None), "w_down": ("heads", "embed")}


def _mlstm_scan_chunks(q, k, v, log_f, log_i, chunk):
    """q, k, v: [B, S, H, D]; log_f, log_i: [B, S, H] float32 (<= 0).
    Returns h [B, S, H, D] in q's dtype."""
    B, S, H, D = q.shape
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {c}")
    nc = S // c
    dt = q.dtype
    qc = q.reshape(B, nc, c, H, D)
    kc = k.reshape(B, nc, c, H, D)
    vc = v.reshape(B, nc, c, H, D)
    lf = log_f.reshape(B, nc, c, H)
    li = log_i.reshape(B, nc, c, H)
    Fc = torch.cumsum(lf, dim=2)                    # within-chunk decay prefix
    Ftot = Fc[:, :, -1, :]                          # [B, nc, H]

    # intra-chunk: att[t, s] = exp(F_t - F_s + li_s) (q_t . k_s), s <= t
    expo = Fc[:, :, :, None, :] - Fc[:, :, None, :, :] + li[:, :, None, :, :]
    tri = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    w = torch.exp(expo.masked_fill(~tri[:, :, None], -math.inf))
    qk = torch.einsum("bnthd,bnshd->bntsh", qc, kc).float()
    aw = w * qk / math.sqrt(D)                      # [B, nc, t, s, H]
    y_intra = torch.einsum("bntsh,bnshd->bnthd", aw.to(dt), vc)
    # normalizer intra part: n_t . q_t = sum_s w[t, s] (k_s . q_t)
    denom_intra = aw.sum(dim=3)                     # [B, nc, t, H]

    # chunk boundary contributions:
    # S_c = sum_s exp(Ftot - F_s + li_s) k_s v_s^T
    wS = torch.exp(Ftot[:, :, None, :] - Fc + li).to(dt)     # [B, nc, c, H]
    Sc = torch.einsum("bnshd,bnshe->bnhde", kc * wS[..., None], vc)
    nSc = torch.einsum("bnsh,bnshd->bnhd", wS, kc)

    # the recurrence over chunks (the reference's lax.scan), out of place:
    # the state before each chunk
    decay = torch.exp(Ftot)                         # [B, nc, H] float32
    C = torch.zeros((B, H, D, D), dtype=dt, device=q.device)
    n = torch.zeros((B, H, D), dtype=dt, device=q.device)
    Cprevs, nprevs = [], []
    for i in range(nc):
        Cprevs.append(C)
        nprevs.append(n)
        dec = decay[:, i].to(dt)
        C = C * dec[:, :, None, None] + Sc[:, i]
        n = n * dec[:, :, None] + nSc[:, i]
    Cprev = torch.stack(Cprevs, dim=1)              # [B, nc, H, D, D]
    nprev = torch.stack(nprevs, dim=1)              # [B, nc, H, D]

    qw = qc * torch.exp(Fc).to(dt)[..., None]       # decay from chunk start
    y_inter = torch.einsum("bnthd,bnhde->bnthe", qw, Cprev) / math.sqrt(D)
    denom_inter = torch.einsum("bnthd,bnhd->bnth", qw, nprev) / math.sqrt(D)

    y = y_intra + y_inter
    denom = torch.clamp((denom_intra + denom_inter.float()).abs(), min=1.0)
    h = y / denom[..., None].to(y.dtype)
    return h.reshape(B, S, H, D)


def _mlstm_inputs(p, x):
    """The block's norm, up projection and split: ``(u, z)``."""
    xin = L.rms_norm(x, p["ln"])
    return (xin @ p["w_up"]).chunk(2, dim=-1)


def mlstm_block(p, cfg, x):
    """x: [B, S, d] -> [B, S, d] (residual added)."""
    B, S, d = x.shape
    nh = cfg.num_heads
    hd = d // nh
    u, z = _mlstm_inputs(p, x)
    q = (u @ p["wq"]).reshape(B, S, nh, hd)
    k = (u @ p["wk"]).reshape(B, S, nh, hd)
    v = (u @ p["wv"]).reshape(B, S, nh, hd)
    gates = (u @ p["w_if"]).float()
    li = F.logsigmoid(gates[..., :nh])
    lf = F.logsigmoid(gates[..., nh:])
    h = _mlstm_scan_chunks(q, k, v, lf, li, cfg.ssm.chunk)
    return x + (h.reshape(B, S, d) * F.silu(z)) @ p["w_down"]


def mlstm_decode(p, cfg, x, state):
    """One token.  x: [B, 1, d]; state {"C": [B, H, D, D], "n": [B, H, D]}.
    Returns (x + out, the new state)."""
    B, _, d = x.shape
    nh = cfg.num_heads
    hd = d // nh
    u, z = _mlstm_inputs(p, x)
    u1 = u[:, 0]
    q = (u1 @ p["wq"]).reshape(B, nh, hd)
    k = (u1 @ p["wk"]).reshape(B, nh, hd)
    v = (u1 @ p["wv"]).reshape(B, nh, hd)
    gates = (u1 @ p["w_if"]).float()
    i = torch.sigmoid(gates[..., :nh])[..., None]
    f = torch.sigmoid(gates[..., nh:])[..., None]
    C = (state["C"] * f[..., None].to(state["C"].dtype)
         + i.to(v.dtype)[..., None] * v[..., :, None] * k[..., None, :])
    n = state["n"] * f.to(state["n"].dtype) + i.to(k.dtype) * k
    num = torch.einsum("bhd,bhed->bhe", q, C) / math.sqrt(hd)
    den = torch.clamp(torch.einsum("bhd,bhd->bh", q, n).abs() / math.sqrt(hd),
                      min=1.0)
    h = (num / den[..., None]).reshape(B, 1, d)
    return x + (h * F.silu(z)) @ p["w_down"], {"C": C, "n": n}


def init_mlstm_state(batch, cfg, device):
    nh = cfg.num_heads
    hd = cfg.d_model // nh
    dt = _dtype(cfg)
    return {"C": torch.zeros((batch, nh, hd, hd), dtype=dt, device=device),
            "n": torch.zeros((batch, nh, hd), dtype=dt, device=device)}


# ---------------------------------------------------------------------------
# sLSTM cell (sequential)
# ---------------------------------------------------------------------------

def init_slstm(gen, cfg):
    d, nh = cfg.d_model, cfg.num_heads
    hd = d // nh
    dt = _dtype(cfg)
    r = torch.randn((nh, hd, 4 * hd), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return {
        "ln": torch.ones((d,), dtype=dt, device=gen.device),
        "w": L.dense_init(gen, d, 4 * d, dt),          # z, i, f, o pre-acts
        "r": r.div_(math.sqrt(hd)).to(dt),             # recurrent, per head
        "w_down": L.dense_init(gen, d, d, dt, scale=1.0 / math.sqrt(d)),
    }


def slstm_pspecs():
    return {"ln": (None,), "w": ("embed", None), "r": ("heads", None, None),
            "w_down": ("embed", "embed")}


def _slstm_step(p, cfg, wx_t, state):
    """wx_t: [B, 4d], the precomputed input part; state h, c, n: [B, H, D].
    Gates in float32; the new state cast to the old one's dtype."""
    nh = cfg.num_heads
    hd = cfg.d_model // nh
    B = wx_t.shape[0]
    rec = torch.einsum("bhd,hde->bhe", state["h"], p["r"])     # [B, H, 4hd]
    pre = (wx_t.reshape(B, nh, 4 * hd) + rec).float()
    z = torch.tanh(pre[..., :hd])
    i, f, o = torch.sigmoid(pre[..., hd:]).chunk(3, dim=-1)
    c = f * state["c"].float() + i * z
    n = f * state["n"].float() + i
    h = o * c / torch.clamp(n, min=1.0)
    dt = state["h"].dtype
    return {"h": h.to(dt), "c": c.to(dt), "n": n.to(dt)}


def _slstm_scan_fwd(wx, r):
    """The sLSTM recurrence over a sequence, from zero states.

    wx: [W, B, S, H, 4D] (the input parts, per head ``[z | i | f | o]``);
    r: [W, H, D, 4D]; W independent stacks (workers: the ``vmap`` rule of
    ``_SLSTMScan`` folds them here; 1 otherwise).  One step a position, on
    ``[W H, B, ...]`` tensors: ``h_{t-1} R + wx_t`` in one ``baddbmm`` (the
    reference rounds the product to the working dtype before the add), the
    gates and states in float32, the cell and normalizer states side by
    side (``[..., 2, D]``), cast to the working dtype as the next step
    reads them.  Returns ``h`` [W, B, S, H, D] (working dtype) and, for the
    backward, the float32 pre-activations ``[S, W, H, B, 4D]`` and states
    ``[S, W, H, B, 2, D]``."""
    W, B, S, H, D4 = wx.shape
    D = D4 // 4
    dt = wx.dtype
    wxs = wx.permute(2, 0, 3, 1, 4).reshape(S, W * H, B, D4)
    rr = r.reshape(W * H, D, D4)
    h = torch.zeros((W * H, B, D), dtype=dt, device=wx.device)
    cn_prev = torch.zeros((W * H, B, 2, D), dtype=torch.float32,
                          device=wx.device)
    hs, pres, cns = [], [], []
    for t in range(S):
        pre = torch.baddbmm(wxs[t], h, rr).float()
        z = torch.tanh(pre[..., :D])
        i, f, o = torch.sigmoid(pre[..., D:]).chunk(3, dim=-1)
        # [c | n] = f [c_prev | n_prev] + [i z | i]
        cn = torch.addcmul(torch.stack([i * z, i], dim=-2), f[..., None, :],
                           cn_prev)
        h = (o * cn[..., 0, :] / torch.clamp(cn[..., 1, :], min=1.0)).to(dt)
        cn_prev = cn.to(dt).float()
        hs.append(h)
        pres.append(pre)
        cns.append(cn)
    h = torch.stack(hs).view(S, W, H, B, D).permute(1, 3, 0, 2, 4)
    return (h.contiguous(), torch.stack(pres).view(S, W, H, B, D4),
            torch.stack(cns).view(S, W, H, B, 2, D))


def _slstm_scan_bwd(gh, r, h, pre, cn):
    """Backpropagation through ``_slstm_scan_fwd``: ``gh`` [W, B, S, H, D]
    (the gradient of ``h``) -> ``(d wx, d r)`` in their dtypes.  The
    gradients run in float32 (the casts of the forward pass them
    unrounded); the terms that need no recurrence (gate derivatives, the
    state ratios) are formed for all positions at once, so a step backward
    is six ops; ``d r`` is one product over all positions."""
    S, W, H, B, D4 = pre.shape
    D = D4 // 4
    WH = W * H
    dt = h.dtype
    pre = pre.reshape(S, WH, B, D4)
    cn = cn.reshape(S, WH, B, 2, D)
    c, n = cn[..., 0, :], cn[..., 1, :]
    z = torch.tanh(pre[..., :D])
    i, f, o = torch.sigmoid(pre[..., D:]).chunk(3, dim=-1)
    cn_prev = torch.cat([torch.zeros_like(cn[:1]), cn[:-1].to(dt).float()])
    c_prev, n_prev = cn_prev[..., 0, :], cn_prev[..., 1, :]
    nc = torch.clamp(n, min=1.0)
    si, sf = i * (1 - i), f * (1 - f)
    # dh -> [dc | dn]
    k_dcn = torch.stack([o / nc, torch.where(n > 1.0, -o * c / (nc * nc),
                                             0.0)], dim=-2)
    zeros = torch.zeros_like(c)
    # d pre = dc kc + dn kn + dh kh, blocks [z | i | f | o]
    kc = torch.stack([i * (1 - z * z), z * si, c_prev * sf, zeros], dim=-2)
    kn = torch.stack([zeros, si, n_prev * sf, zeros], dim=-2)
    kh = torch.stack([zeros, zeros, zeros, c / nc * o * (1 - o)], dim=-2)
    f2 = f[..., None, :]
    ghs = gh.float().permute(2, 0, 3, 1, 4).reshape(S, WH, B, D)
    rT = r.reshape(WH, D, D4).transpose(1, 2).float()
    dcn_car = torch.zeros_like(cn[0])
    dpres = [None] * S
    for t in reversed(range(S)):
        # dh_t = the output's gradient + d pre_{t+1} R^T
        dh = (ghs[t] if t == S - 1
              else torch.baddbmm(ghs[t], dpres[t + 1], rT))
        dcn = torch.addcmul(dcn_car, dh[..., None, :], k_dcn[t])
        dp = (dcn[..., :1, :] * kc[t]).addcmul_(dcn[..., 1:, :], kn[t]
                                                ).addcmul_(dh[..., None, :],
                                                           kh[t])
        dcn_car = dcn * f2[t]
        dpres[t] = dp.view(WH, B, D4)
    dpre = torch.stack(dpres)                       # [S, WH, B, 4D]
    d_wx = dpre.view(S, W, H, B, D4).permute(1, 3, 0, 2, 4).to(dt)
    hs = h.permute(2, 0, 3, 1, 4).reshape(S, WH, B, D)
    h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]]).float()
    d_r = torch.bmm(h_prev.permute(1, 3, 0, 2).reshape(WH, D, S * B),
                    dpre.permute(1, 0, 2, 3).reshape(WH, S * B, D4))
    return d_wx.contiguous(), d_r.view(W, H, D, D4).to(r.dtype)


def _fold(t, d, at, n):
    """The vmapped dim ``d`` of ``t`` (``None``: unbatched, expanded)
    merged into its stack dim ``at``: ``n`` stacks of ``W`` -> ``n W``."""
    if d is None:
        t = t.unsqueeze(at).expand(*t.shape[:at], n, *t.shape[at:])
    else:
        t = t.movedim(d, at)
    return t.flatten(at, at + 1)


class _SLSTMScan(torch.autograd.Function):
    """The sLSTM time loop with a hand-written backward
    (``_slstm_scan_bwd``), so that a training step's backward is a loop of
    a few plain ops a position instead of autograd's graph of the forward
    loop; with ``vmap`` rules for it and its backward that fold the
    workers of ``torch.func.vmap(grad)`` into the stack dim W, so both
    loops run once on plain tensors for all workers.  Outputs: ``h`` and
    the states the backward reads (not differentiable)."""

    @staticmethod
    def forward(wx, r):
        return _slstm_scan_fwd(wx, r)

    @staticmethod
    def setup_context(ctx, inputs, output):
        h, pre, cn = output
        ctx.save_for_backward(inputs[1], h, pre, cn)
        ctx.mark_non_differentiable(pre, cn)

    @staticmethod
    def backward(ctx, gh, *_):
        return _SLSTMScanGrad.apply(gh, *ctx.saved_tensors)

    @staticmethod
    def vmap(info, in_dims, wx, r):
        n = info.batch_size
        h, pre, cn = _SLSTMScan.apply(_fold(wx, in_dims[0], 0, n),
                                      _fold(r, in_dims[1], 0, n))
        return ((h.unflatten(0, (n, -1)), pre.unflatten(1, (n, -1)),
                 cn.unflatten(1, (n, -1))), (0, 1, 1))


class _SLSTMScanGrad(torch.autograd.Function):
    """``_SLSTMScan``'s backward as a function with a ``vmap`` rule (no
    double backward)."""

    @staticmethod
    def forward(gh, r, h, pre, cn):
        return _slstm_scan_bwd(gh, r, h, pre, cn)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("the sLSTM scan has no second derivative")

    @staticmethod
    def vmap(info, in_dims, gh, r, h, pre, cn):
        k = info.batch_size
        args = [_fold(t, d, at, k) for t, d, at in
                zip((gh, r, h, pre, cn), in_dims, (0, 0, 0, 1, 1))]
        d_wx, d_r = _slstm_scan_bwd(*args)
        return (d_wx.unflatten(0, (k, -1)), d_r.unflatten(0, (k, -1))), (0, 0)


def slstm_block(p, cfg, x):
    """x: [B, S, d] -> [B, S, d] (residual added), one step a position
    (``_SLSTMScan``)."""
    B, S, d = x.shape
    nh = cfg.num_heads
    hd = d // nh
    wx = (L.rms_norm(x, p["ln"]) @ p["w"]).reshape(1, B, S, nh, 4 * hd)
    h, *_ = _SLSTMScan.apply(wx, p["r"][None])
    return x + h.reshape(B, S, d) @ p["w_down"]


def slstm_decode(p, cfg, x, state):
    """One token.  x: [B, 1, d]; returns (x + out, the new state)."""
    wx = (L.rms_norm(x, p["ln"]) @ p["w"])[:, 0]
    st = _slstm_step(p, cfg, wx, state)
    h = st["h"].reshape(x.shape[0], 1, cfg.d_model)
    return x + h @ p["w_down"], st


def init_slstm_state(batch, cfg, device):
    nh = cfg.num_heads
    hd = cfg.d_model // nh
    z = torch.zeros((batch, nh, hd), dtype=_dtype(cfg), device=device)
    return {"h": z, "c": z, "n": z}
