"""Recurrent blocks of the port: mLSTM and sLSTM (xLSTM) and Mamba2 (SSD),
the counterpart of :mod:`repro.models.ssm`.

The shared engine is :func:`chunked_lin_attn`, a chunkwise-parallel linear
recurrence ``S_t = a_t S_{t-1} + k_t (x) v_t``, ``y_t = S_t q_t`` with a
per-step log-decay, in f32.  Within a chunk it is a masked product; the
chunks' summaries are combined by an exclusive scan over the chunks
(``S_in[c] = A[c-1] S_in[c-1] + B[c-1]``; the reference's
``lax.associative_scan`` computes the same states), each state read by its
chunk as the scan reaches it.  The decay gates are
sigmoidal, so every exponent is clipped to [-60, 0], as in the reference.

Each block is an ``nn.Module`` with ``forward`` (a whole (B, S, d)
sequence), ``decode`` (one token against its cache, updated **in place**)
and ``init_cache``.  Parameters keep the reference's names and layouts
(``wi``, ``wf``, ``conv``, ``A_log``, ``D`` and ``dt_bias`` in f32, the
rest in the model's type).  No CUDA kernel is on this path: the reference
has no Pallas kernel here, and plain tensor ops serve.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .attention import _lead
from .layers import (dot, dot_column, over_columns, over_rows, param,
                     rms_norm)

CLIP = 60.0          # every exponent of a decay lies in [-CLIP, 0]
CONV_W = 4           # Mamba2's causal depthwise conv width
MAMBA_HEAD = 64      # Mamba2's head dim


def _decay(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x.clamp(-CLIP, 0.0))


def chunked_lin_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     logf: torch.Tensor, *, chunk: int) -> torch.Tensor:
    """q, k: (B, S, H, dk); v: (B, S, H, dv); logf: (B, S, H), <= 0; all
    f32.  -> y (B, S, H, dv) with ``y_t = q_t . sum_{s<=t} (prod_{u in
    (s, t]} f_u) k_s (x) v_s``.  The caller folds the input gate into v
    (or k)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    qc = q.reshape(b, nc, chunk, h, dk)
    kc = k.reshape(b, nc, chunk, h, dk)
    vc = v.reshape(b, nc, chunk, h, dv)
    cum = logf.reshape(b, nc, chunk, h).cumsum(2)      # inclusive
    tot = cum[:, :, -1]                                # (B, nc, H)

    # within a chunk: the weight of step s at step t (s <= t) is
    # exp(cum_t - cum_s)
    att = torch.einsum("bcthd,bcshd->bchts", qc, kc)
    cum_t = cum.permute(0, 1, 3, 2)                    # (B, nc, H, ch)
    w = _decay(cum_t[..., :, None] - cum_t[..., None, :])
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=q.device).tril()
    w = torch.where(mask, w, 0.0)
    intra = torch.einsum("bchts,bcshd->bcthd", att * w, vc)

    # each chunk's summary, then the state entering each chunk
    to_end = _decay(tot[:, :, None] - cum)             # (B, nc, ch, H)
    summary = torch.einsum("bcshd,bcshe->bchde", kc * to_end[..., None], vc)
    a = _decay(tot)                                    # (B, nc, H)
    # each chunk's cross term from the state entering it, one state at a
    # time: no (B, nc, H, dk, dv) stack of states, and no state written
    # over while autograd holds it for a product
    qd = qc * _decay(cum)[..., None]
    state = torch.zeros_like(summary[:, 0])
    cross = []
    for c in range(nc):
        cross.append(torch.einsum("bthd,bhde->bthe", qd[:, c], state))
        if c + 1 < nc:
            state = a[:, c, :, None, None] * state + summary[:, c]
    return (intra + torch.stack(cross, 1)).reshape(b, s, h, dv)


def lin_attn_step(state: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, f: torch.Tensor):
    """One decode step of the same recurrence, ``state`` (B, H, dk, dv)
    updated in place: q, k (B, H, dk); v (B, H, dv); f (B, H) in (0, 1)
    (no clip, as in the reference).  -> (state, y (B, H, dv))."""
    state.mul_(f[..., None, None]).add_(k[..., :, None] * v[..., None, :])
    return state, torch.einsum("bhd,bhde->bhe", q, state)


# ---------------------------------------------------------------------------
# mLSTM (xLSTM's matrix cell)
# ---------------------------------------------------------------------------

class MLSTMBlock(nn.Module):
    """Pre-norm mLSTM block: two up-projections to ``di = 2 d``, the matrix
    cell over ``n_heads`` heads of ``di / n_heads`` (input gate folded into
    v beside a ones column for the normaliser), the SiLU gate, and the
    down-projection.  Over "model" (:meth:`split_regions`) ``up1`` stays
    whole on the data shard's first position and ``u`` goes to every
    position as an f32 copy; each computes its heads (or its value columns
    of one head) and its f32 partial by its rows of ``down``."""

    CELL = ("wq", "wk", "wv", "wi", "wf")

    def __init__(self, d: int, n_heads: int, eps: float, dtype, device):
        super().__init__()
        di = 2 * d
        self.n_heads, self.eps = n_heads, eps
        self.ln = param((d,), dtype, device)
        self.up1 = param((d, di), dtype, device)
        self.up2 = param((d, di), dtype, device)
        self.wq = param((di, di), dtype, device)
        self.wk = param((di, di), dtype, device)
        self.wv = param((di, di), dtype, device)
        self.wi = param((di, n_heads), torch.float32, device)
        self.wf = param((di, n_heads), torch.float32, device)
        self.down = param((di, d), dtype, device)

    def projections(self) -> list[torch.Tensor]:
        return [self.up1, self.up2, self.wq, self.wk, self.wv, self.wi,
                self.wf, self.down]

    def split_regions(self, n_model: int) -> dict:
        """``{name: [region each of n_model "model" positions computes
        with]}``.  Where M divides the H heads, position m takes heads
        ``[m H/M, (m+1) H/M)``: their columns of ``wq``, ``wk``, ``wv``,
        ``wi``, ``wf`` and ``up2`` (the gate multiplies the hidden units
        column by column) and their rows of ``down``.  Where H divides M
        (and M / H divides dh), position m takes ``dh H / M`` value
        columns of head ``m // (M / H)``: that head's whole columns of
        ``wq``, ``wk``, ``wi`` and ``wf`` (read by the head's M / H
        positions) and its own columns of ``wv`` and ``up2`` and rows of
        ``down``; it computes the normaliser column itself.  Otherwise,
        and at M = 1, empty: the block is computed whole.  ``up1`` is
        never split: every position reads all of ``u``."""
        h = self.n_heads
        d, di = self.up1.shape
        dh = di // h
        if n_model > 1 and h % n_model == 0:
            hm = h // n_model
            heads = [(m * hm, (m + 1) * hm) for m in range(n_model)]
            values = [slice(h0 * dh, h1 * dh) for h0, h1 in heads]
        elif n_model > 1 and n_model % h == 0 and dh % (n_model // h) == 0:
            per = n_model // h
            w = dh // per
            heads = [(m // per, m // per + 1) for m in range(n_model)]
            values = [slice(m // per * dh + m % per * w,
                            m // per * dh + (m % per + 1) * w)
                      for m in range(n_model)]
        else:
            return {}
        out: dict = {}
        every, rows = slice(0, di), slice(0, d)
        for (h0, h1), v in zip(heads, values):
            cols = slice(h0 * dh, h1 * dh)
            for name, region in (("wq", (every, cols)), ("wk", (every, cols)),
                                 ("wv", (every, v)),
                                 ("wi", (every, slice(h0, h1))),
                                 ("wf", (every, slice(h0, h1))),
                                 ("up2", (rows, v)), ("down", (v, rows))):
                out.setdefault(name, []).append(region)
        return out

    def _cell(self, w: dict, u: torch.Tensor, uf: torch.Tensor, prod):
        """The cell's inputs for the heads of ``w`` (``wq``, ``wk``,
        ``wv``, ``wi``, ``wf``; as many heads as ``wi`` has columns):
        -> q, k (B, S, h, dh), v_aug (B, S, h, dv + 1) all f32, logf (B,
        S, h), with ``prod(u, w)`` the products and ``uf`` u in f32; k
        scaled by the head's ``dh ** -0.5`` whatever the value columns."""
        b, s, _ = uf.shape
        h = w["wi"].shape[1]
        dh = self.up1.shape[1] // self.n_heads
        q = prod(u, w["wq"]).reshape(b, s, h, dh)
        k = prod(u, w["wk"]).reshape(b, s, h, dh) * (dh ** -0.5)
        v = prod(u, w["wv"]).reshape(b, s, h, -1)
        i = torch.sigmoid(uf @ w["wi"])
        logf = F.logsigmoid(uf @ w["wf"])
        iv = i[..., None].to(v.dtype)
        v_aug = torch.cat([v * iv, iv], dim=-1)
        return q.float(), k.float(), v_aug.float(), logf

    def _cell_inputs(self, x: torch.Tensor):
        """-> gate (B, S, di) f32, q, k (B, S, H, dh), v_aug (B, S, H,
        dh + 1) all f32, logf (B, S, H)."""
        xn = rms_norm(x, self.ln, self.eps)
        u = dot(xn, self.up1)
        gate = F.silu(dot(xn, self.up2).float())
        w = {n: getattr(self, n) for n in self.CELL}
        return (gate, *self._cell(w, u, u.float(), dot))

    @staticmethod
    def _hidden(y, gate, dtype) -> torch.Tensor:
        """The gated hidden units (B, S, h dv) in ``dtype`` from the cell's
        output ``y`` (B, S, h, dv + 1): numerator over the normaliser."""
        b, s, _ = gate.shape
        hid = y[..., :-1] / y[..., -1].abs().clamp_min(1.0)[..., None]
        return (hid.reshape(b, s, -1) * gate).to(dtype)

    def forward(self, x: torch.Tensor, ctx: dict) -> torch.Tensor:
        split = ctx.get("model_split")
        parts = split.parts(self) if split is not None else None
        chunk = ctx.get("ssm_chunk", 256)
        if parts is not None:
            return self._over_model(x, split, parts, chunk)
        gate, q, k, v_aug, logf = self._cell_inputs(x)
        y = chunked_lin_attn(q, k, v_aug, logf, chunk=chunk)
        return x + dot(self._hidden(y, gate, x.dtype), self.down)

    def _over_model(self, x, split, parts, chunk) -> torch.Tensor:
        """The block over "model": ``u`` whole here, then on each position
        its heads' (value columns') cell and gate from f32 copies of ``u``
        and of the normed input, and the f32 partials by its rows of
        ``down`` added in mesh order."""
        xn = rms_norm(x, self.ln, self.eps)
        us = split.to_model(dot(xn, self.up1).float())
        gates = over_columns(split, xn, [p["up2"] for p in parts])
        hids = []
        for um, gm, p in zip(us, gates, parts):
            q, k, v_aug, logf = self._cell(p, um, um, dot_column)
            y = chunked_lin_attn(q, k, v_aug, logf, chunk=chunk)
            hids.append(self._hidden(y, F.silu(gm.float()), x.dtype))
        return x + over_rows(split, hids, [p["down"] for p in parts])

    def decode(self, cache_l: dict, x: torch.Tensor, ctx: dict):
        gate, q, k, v_aug, logf = self._cell_inputs(x)
        _, y = lin_attn_step(cache_l["state"], q[:, 0], k[:, 0], v_aug[:, 0],
                             torch.exp(logf[:, 0]))
        return x + dot(self._hidden(y[:, None], gate, x.dtype),
                       self.down), cache_l

    def init_cache(self, lead, b: int, device) -> dict:
        di = self.up1.shape[1]
        dh = di // self.n_heads
        return {"state": torch.zeros(_lead(lead) + (b, self.n_heads, dh,
                                                    dh + 1),
                                     dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------------
# sLSTM (scalar cell, block-diagonal recurrence; strictly sequential)
# ---------------------------------------------------------------------------

class SLSTMBlock(nn.Module):
    """Pre-norm sLSTM block: input projections ``wz, wi, wf, wo`` (d, d),
    block-diagonal recurrent products ``rz ... ro`` (H, dh, dh) in f32,
    exponential-free gates (tanh / sigmoid), a stabilised normaliser, and
    the down-projection.  The forward is a Python loop over the sequence,
    as the reference's ``lax.scan`` is strictly sequential; the input
    projections of every step are one product before it.  Over "model"
    (:meth:`split_regions`) each position runs the loop on its own heads:
    the recurrence is block-diagonal by head, so the loop needs no
    collective."""

    GATES = ("wz", "wi", "wf", "wo")
    RECURRENT = ("rz", "ri", "rf", "ro")

    def __init__(self, d: int, n_heads: int, eps: float, dtype, device):
        super().__init__()
        dh = d // n_heads
        self.n_heads, self.eps = n_heads, eps
        self.ln = param((d,), dtype, device)
        for n in self.GATES:
            setattr(self, n, param((d, d), dtype, device))
        for n in self.RECURRENT:
            setattr(self, n, param((n_heads, dh, dh), dtype, device))
        self.down = param((d, d), dtype, device)

    def projections(self) -> list[torch.Tensor]:
        return [self.wz, self.wi, self.wf, self.wo, self.rz, self.ri,
                self.rf, self.ro, self.down]

    def split_regions(self, n_model: int) -> dict:
        """``{name: [region each of n_model "model" positions computes
        with]}``: where M divides the H heads, position m's heads ``[m
        H/M, (m+1) H/M)``, their columns of ``wz``, ``wi``, ``wf``,
        ``wo``, their slices of ``rz`` ... ``ro`` along the head dim and
        their rows of ``down``.  Otherwise, and at M = 1, empty: a split
        inside a head would need the whole ``h`` every step."""
        h, d = self.n_heads, self.down.shape[0]
        if n_model == 1 or h % n_model:
            return {}
        dh, hm = d // h, h // n_model
        out: dict = {}
        rows, inner = slice(0, d), slice(0, dh)
        for m in range(n_model):
            heads = slice(m * hm, (m + 1) * hm)
            cols = slice(heads.start * dh, heads.stop * dh)
            for n in self.GATES:
                out.setdefault(n, []).append((rows, cols))
            for n in self.RECURRENT:
                out.setdefault(n, []).append((heads, inner, inner))
            out.setdefault("down", []).append((cols, rows))
        return out

    def _weights(self, p: "dict | None" = None):
        """(W (d, 4d), R (H, dh, 4 dh)) in f32: the four gates' input and
        recurrent weights side by side, in the order z, i, f, o; of the
        heads of ``p`` (a position's parts) where given."""
        p = p if p is not None else {n: getattr(self, n)
                                     for n in self.GATES + self.RECURRENT}
        w = torch.cat([p[n] for n in self.GATES], 1).float()
        r = torch.cat([p[n] for n in self.RECURRENT], 2).float()
        return w, r

    @staticmethod
    def _step(xg: torch.Tensor, r: torch.Tensor, c, n, h):
        """xg: (B, 4d) the step's input pre-activations; (c, n, h) (B, d)
        over the ``r.shape[0]`` heads of ``r``.  -> the new (c, n, h)."""
        b, d = h.shape
        nh = r.shape[0]
        rec = torch.einsum("bhd,hde->bhe", h.reshape(b, nh, d // nh), r)
        rec = rec.reshape(b, nh, 4, d // nh).transpose(1, 2).reshape(b, 4, d)
        pre = xg.reshape(b, 4, d) + rec
        z = torch.tanh(pre[:, 0])
        i, f, o = torch.sigmoid(pre[:, 1:]).unbind(1)
        c = f * c + i * z
        n = f * n + i
        return c, n, o * c / n.clamp_min(1.0)

    def _scan(self, xg: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        """The loop over the sequence from zero state: xg (B, S, 4d) ->
        the h of every step (B, S, d), f32."""
        b, s, d4 = xg.shape
        c = n = h = torch.zeros((b, d4 // 4), dtype=torch.float32,
                                device=xg.device)
        hs = []
        for t in range(s):
            c, n, h = self._step(xg[:, t], r, c, n, h)
            hs.append(h)
        return torch.stack(hs, 1)

    def forward(self, x: torch.Tensor, ctx: dict) -> torch.Tensor:
        split = ctx.get("model_split")
        parts = split.parts(self) if split is not None else None
        xn = rms_norm(x, self.ln, self.eps).float()
        if parts is not None:
            # each position's loop over its heads, one after another
            hs = []
            for xm, p in zip(split.to_model(xn), parts):
                w, r = self._weights(p)
                hs.append(self._scan(xm @ w, r).to(x.dtype))
            return x + over_rows(split, hs, [p["down"] for p in parts])
        w, r = self._weights()
        return x + dot(self._scan(xn @ w, r).to(x.dtype), self.down)

    def decode(self, cache_l: dict, x: torch.Tensor, ctx: dict):
        w, r = self._weights()
        xg = rms_norm(x, self.ln, self.eps).float()[:, 0] @ w
        c, n, h = self._step(xg, r, cache_l["c"], cache_l["n"], cache_l["h"])
        for name, t in (("c", c), ("n", n), ("h", h)):
            cache_l[name].copy_(t)
        return x + dot(h[:, None].to(x.dtype), self.down), cache_l

    def init_cache(self, lead, b: int, device) -> dict:
        d = self.down.shape[0]
        return {n: torch.zeros(_lead(lead) + (b, d), dtype=torch.float32,
                               device=device) for n in ("c", "n", "h")}


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------

def causal_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of width ``CONV_W`` in u's type (the weight
    cast to it, the taps summed in order), then SiLU in f32.  u: (B, S, C);
    w: (C, CONV_W)."""
    s = u.shape[1]
    pads = F.pad(u, (0, 0, CONV_W - 1, 0))
    wu = w.to(u.dtype)
    out = pads[:, 0:s] * wu[:, 0]
    for i in range(1, CONV_W):
        out = out + pads[:, i:i + s] * wu[:, i]
    return F.silu(out.float()).to(u.dtype)


def conv_history(conv: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One decode step's conv window: the cached history ``conv`` (B,
    CONV_W - 1, C) f32 then the step's input ``u`` (B, C) -> (B, CONV_W,
    C) f32; ``conv`` shifts by one slot in place (the oldest input
    leaves)."""
    hist = torch.cat([conv, u[:, None].float()], dim=1)
    conv.copy_(hist[:, 1:])
    return hist


class Mamba2Block(nn.Module):
    """Pre-norm Mamba2 block: one input projection to (z, x, B, C, dt), a
    causal depthwise conv over (x, B, C), the SSD recurrence over ``di /
    64`` heads of 64 with a ``d_state`` state (B as the key and C as the
    query of every head), the skip ``D``, the SiLU(z) gate and the output
    projection.  ``A_log`` = 0, ``D`` = 1 and ``dt_bias`` = 0 as
    initialised (never drawn)."""

    ONES = ("D",)       # made as ones (every other parameter as zeros)

    def __init__(self, d: int, d_state: int, eps: float, dtype, device):
        super().__init__()
        di = 2 * d
        nh = di // MAMBA_HEAD
        self.d_state, self.eps = d_state, eps
        conv_ch = di + 2 * d_state
        f32 = torch.float32
        self.ln = param((d,), dtype, device)
        self.in_proj = param((d, 2 * di + 2 * d_state + nh), dtype, device)
        self.conv = param((conv_ch, CONV_W), f32, device)
        self.A_log = param((nh,), f32, device)
        self.D = nn.Parameter(torch.ones((nh,), dtype=f32, device=device),
                              requires_grad=False)
        self.dt_bias = param((nh,), f32, device)
        self.out_proj = param((di, d), dtype, device)

    def projections(self) -> list[torch.Tensor]:
        return [self.in_proj, self.conv, self.out_proj]

    def split_regions(self, n_model: int) -> dict:
        """``{name: [region each of n_model "model" positions computes
        with]}``: where M divides the ``nh = di / 64`` heads, position m's
        heads ``[m nh/M, (m+1) nh/M)``: four column ranges of ``in_proj``
        (their ``z`` columns, their ``x`` columns, all of ``B`` and ``C``,
        their ``dt`` columns), two row ranges of ``conv`` (their ``x``
        channels, then ``B`` and ``C``: the conv is depthwise), their
        entries of ``A_log``, ``dt_bias`` and ``D`` and their rows of
        ``out_proj``.  Otherwise, and at M = 1, empty: whole."""
        di, d = self.out_proj.shape
        nh, ds = di // MAMBA_HEAD, self.d_state
        if n_model == 1 or nh % n_model:
            return {}
        hm = nh // n_model
        out: dict = {}
        bc, dt0 = slice(2 * di, 2 * di + 2 * ds), 2 * di + 2 * ds
        for m in range(n_model):
            h0, h1 = m * hm, (m + 1) * hm
            xs = slice(h0 * MAMBA_HEAD, h1 * MAMBA_HEAD)
            cols = (xs, slice(di + xs.start, di + xs.stop), bc,
                    slice(dt0 + h0, dt0 + h1))
            for name, region in (
                    ("in_proj", (slice(0, d), cols)),
                    ("conv", ((xs, slice(di, di + 2 * ds)),
                              slice(0, CONV_W))),
                    ("A_log", (slice(h0, h1),)), ("dt_bias", (slice(h0, h1),)),
                    ("D", (slice(h0, h1),)), ("out_proj", (xs, slice(0, d)))):
                out.setdefault(name, []).append(region)
        return out

    def _fields(self, zxbcdt: torch.Tensor, nh: int):
        """(z, x, B, C, dt) of ``nh`` heads' input projection."""
        di, ds = nh * MAMBA_HEAD, self.d_state
        return zxbcdt.split([di, di, ds, ds, nh], dim=-1)

    @staticmethod
    def _gate(y: torch.Tensor, z: torch.Tensor, dtype) -> torch.Tensor:
        """The SSD output ``y`` gated by SiLU(z) in f32, in ``dtype``."""
        return (y * F.silu(z.float())).to(dtype)

    def _ssd(self, zxbcdt: torch.Tensor, p: dict, chunk: int, dtype
             ) -> torch.Tensor:
        """The gated SSD output (B, S, h 64) in ``dtype`` of the heads of
        ``p`` (``conv``, ``A_log``, ``dt_bias``, ``D``; as many heads as
        ``A_log`` has entries) from their input projection ``zxbcdt`` (z,
        x, B, C, dt)."""
        b, s, _ = zxbcdt.shape
        nh, ds = p["A_log"].shape[0], self.d_state
        di = nh * MAMBA_HEAD
        z, xin, bc, cc, dt_raw = self._fields(zxbcdt, nh)
        conv = causal_conv(torch.cat([xin, bc, cc], dim=-1), p["conv"])
        xin, bc, cc = conv.split([di, ds, ds], dim=-1)
        dt = F.softplus(dt_raw.float() + p["dt_bias"])           # (B,S,nh)
        logf = dt * -torch.exp(p["A_log"])
        xh = xin.reshape(b, s, nh, MAMBA_HEAD).float()
        k = bc[:, :, None, :].expand(b, s, nh, ds).float()
        q = cc[:, :, None, :].expand(b, s, nh, ds).float()
        y = chunked_lin_attn(q, k, xh * dt[..., None], logf, chunk=chunk)
        y = y + xh * p["D"][:, None]
        return self._gate(y.reshape(b, s, di), z, dtype)

    def forward(self, x: torch.Tensor, ctx: dict) -> torch.Tensor:
        split = ctx.get("model_split")
        parts = split.parts(self) if split is not None else None
        chunk = ctx.get("ssm_chunk", 256)
        xn = rms_norm(x, self.ln, self.eps)
        if parts is not None:
            # each position its heads (and all of B and C), then the f32
            # partials by its rows of out_proj added in mesh order
            ys = [self._ssd(zm, p, chunk, x.dtype) for zm, p in zip(
                over_columns(split, xn, [p["in_proj"] for p in parts]),
                parts)]
            return x + over_rows(split, ys, [p["out_proj"] for p in parts])
        own = {n: getattr(self, n) for n in ("conv", "A_log", "dt_bias", "D")}
        return x + dot(self._ssd(dot(xn, self.in_proj), own, chunk, x.dtype),
                       self.out_proj)

    def decode(self, cache_l: dict, x: torch.Tensor, ctx: dict):
        """One token; the conv history stays f32 (as the reference's), so
        in bf16 its conv rounds differently from the forward's."""
        b = x.shape[0]
        nh, ds = self.A_log.shape[0], self.d_state
        di = nh * MAMBA_HEAD
        z, xin, bc, cc, dt_raw = self._fields(
            dot(rms_norm(x, self.ln, self.eps), self.in_proj), nh)
        hist = conv_history(cache_l["conv"],
                            torch.cat([xin, bc, cc], dim=-1)[:, 0])
        conv = F.silu((hist * self.conv.T[None]).sum(1))          # (B, C)
        xin, bc, cc = conv.split([di, ds, ds], dim=-1)
        dt = F.softplus(dt_raw.float()[:, 0] + self.dt_bias)      # (B, nh)
        f = torch.exp(dt * -torch.exp(self.A_log))
        xh = xin.reshape(b, nh, MAMBA_HEAD)
        k = bc[:, None, :].expand(b, nh, ds)
        q = cc[:, None, :].expand(b, nh, ds)
        _, y = lin_attn_step(cache_l["state"], q, k, xh * dt[..., None], f)
        y = y + xh * self.D[:, None]
        return x + dot(self._gate(y.reshape(b, 1, di), z, x.dtype),
                       self.out_proj), cache_l

    def init_cache(self, lead, b: int, device) -> dict:
        di = self.out_proj.shape[0]
        lead = _lead(lead)
        f32 = dict(dtype=torch.float32, device=device)
        return {"state": torch.zeros(lead + (b, di // MAMBA_HEAD,
                                             self.d_state, MAMBA_HEAD),
                                     **f32),
                "conv": torch.zeros(lead + (b, CONV_W - 1,
                                            di + 2 * self.d_state), **f32)}
