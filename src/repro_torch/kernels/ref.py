"""Plain PyTorch versions of the port's kernels: what each wrapper computes on
a CPU tensor, and what ``chip_smoke.py`` holds each CUDA kernel to on the
card.  They repeat the kernels' arithmetic (f32 accumulation, cast back to
the input dtype) and are no yardstick of speed."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def gossip_mix_ref(ws: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """ws: (R, n, n); x: (n, D) -> W_{R-1} ... W_0 x, accumulated in f32 and
    returned in ``x.dtype`` (the JAX package's ``kernels/ref.py``
    ``gossip_mix_ref``)."""
    out = x.to(torch.float32)
    for r in range(ws.shape[0]):
        out = ws[r].to(torch.float32) @ out
    return out.to(x.dtype)


def gossip_mix_tiled_ref(ws: torch.Tensor, x: torch.Tensor, geometry: dict,
                         blocks: int = 3) -> torch.Tensor:
    """The Hopper kernel's tile route walked on the CPU, as a
    :func:`repro_torch.kernels.gossip_matmul.launch_geometry` dict lays it
    out: the R rounds collapsed into W = W_{R-1} ... W_0 (row i as a row
    vector times W_{R-2}, ..., W_0), stored transposed and zero-padded to
    ``rows_pad`` columns; ``blocks`` persistent blocks taking column tiles
    of ``tc`` in turn, each through a ring of ``stages`` stages (rows and
    columns past the input staged as zeros, as TMA's fill leaves them); a
    tile cut in micro-tiles of 8 rows x ``cm`` columns (quads of 4, 4 lc
    apart), micro-tile u of a pass at the row and column group of its warp
    tile and lane; W^T resident or in chunks of ``kc`` of its rows, each
    chunk's sums added to the partial sums kept in the block's f32 buffer;
    the last chunk storing, rounded once to ``x.dtype``.  Each micro-tile
    is computed exactly once (checked).  Agrees with :func:`gossip_mix_ref`
    to f32 rounding."""
    g = geometry
    R, n, _ = ws.shape
    D = x.shape[1]
    tc, rp, lr, lc, cm = g["tc"], g["rows_pad"], g["lr"], g["lc"], g["cm"]
    units, threads, kc, stages = g["units"], g["threads"], g["kc"], \
        g["stages"]
    if (rp < n or rp % (8 * lr) or tc % (cm * lc)
            or units != rp // 8 * tc // cm):
        raise ValueError(f"geometry {g} does not tile n={n}")
    w = ws.to(torch.float32)
    v = w[R - 1]
    for r in range(R - 2, -1, -1):
        v = v @ w[r]
    wt = torch.zeros(n, rp)
    wt[:, :n] = v.T
    u = torch.arange(units)
    wtile, lane, wct = u // 32, u % 32, tc // (cm * lc)
    i0 = 8 * ((wtile // wct) * lr + lane // lc)
    c0 = (wtile % wct) * cm * lc + 4 * (lane % lc)
    rows = i0[:, None] + torch.arange(8)          # (units, 8)
    quads = torch.arange(cm // 4) * 4 * lc        # (cm / 4,)
    cols = (c0[:, None, None] + quads[None, :, None]
            + torch.arange(4)).reshape(units, cm)  # (units, cm)
    if len({(i, c) for i, cs in zip(i0.tolist(), cols.tolist())
            for c in cs}) != units * cm:
        raise ValueError(f"geometry {g} computes a micro-tile twice")
    passes = [slice(v, v + threads) for v in range(0, units, threads)]
    srows = g["box_rows"] * g["boxes"]
    tiles = -(-D // tc)
    out = torch.empty_like(x)

    def fill(ring, s, tile):
        ring[s].zero_()
        c = tile * tc
        ring[s, :n, :min(tc, D - c)] = x[:, c:c + tc]

    for b in range(blocks):
        mine = list(range(b, tiles, blocks))
        ring = torch.zeros(stages, srows, tc, dtype=x.dtype)
        buf = torch.zeros(rp, tc)   # rows past n stay zero
        for k in range(min(stages, len(mine))):
            fill(ring, k, mine[k])
        for k, tile in enumerate(mine):
            s, col0 = k % stages, tile * tc
            ncol = min(tc, D - col0)
            src = ring[s].to(torch.float32)
            for j0 in range(0, n, kc):
                j1 = min(j0 + kc, n)
                for p in passes:
                    acc = (torch.zeros(rows[p].shape[0], 8, cm) if j0 == 0
                           else buf[rows[p][:, :, None], cols[p][:, None, :]])
                    acc = acc + torch.einsum("jup,juq->upq",
                                             wt[j0:j1][:, rows[p]],
                                             src[j0:j1][:, cols[p]])
                    if j1 == n:
                        keep = ((rows[p] < n)[:, :, None]
                                & (cols[p] < ncol)[:, None, :])
                        ri = rows[p][:, :, None].expand_as(acc)[keep]
                        ci = cols[p][:, None, :].expand_as(acc)[keep]
                        out[ri, col0 + ci] = acc[keep].to(x.dtype)
                    else:
                        buf[rows[p][:, :, None], cols[p][:, None, :]] = \
                            acc * (rows[p] < n)[:, :, None]
            if k + stages < len(mine):
                fill(ring, s, mine[k + stages])
    return out


def quantize_dequantize_ref(buf: torch.Tensor, *, scheme: str,
                            group: int = 256):
    """Group-wise quantize -> dequantize of an (n, D) f32 matrix (D % group
    == 0): (dequantized, error = buf - dequantized).  The JAX package's
    ``kernels/ref.py`` ``quantize_dequantize_ref``.

    ``sign``: sign(g)·mean|g| per (node, group), sign(0) = 0, so an all-zero
    group stays zero.  ``int8``: s = max|g| / 127 (a division, as the
    reference: multiplying by 1/127 differs in the last bit), q =
    clip(round(g / s), ±127) with ``torch.round`` rounding half to even
    like ``jnp.round``, deq = q·s; an all-zero group divides by 1 instead
    of 0 and stays zero.

    Both divisors are 0-dim tensors on ``buf``'s device: on a CUDA tensor
    PyTorch turns a division by a Python number into a product by its
    reciprocal, which differs from the division in the last bit."""
    n, D = buf.shape
    if D % group:
        raise ValueError(f"D={D} is not a multiple of group={group}")
    g = buf.reshape(n, D // group, group)
    if scheme == "sign":
        scale = (g.abs().sum(dim=-1, keepdim=True)
                 / torch.full((), float(group), device=g.device))
        deq = torch.sign(g) * scale
    elif scheme == "int8":
        scale = (g.abs().amax(dim=-1, keepdim=True)
                 / torch.full((), 127.0, device=g.device))
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        q = torch.clamp(torch.round(g / safe), -127.0, 127.0)
        deq = q * scale
    else:
        raise ValueError(f"unknown compression scheme {scheme!r} "
                         "(quantizing schemes: 'sign', 'int8')")
    deq = deq.reshape(n, D)
    return deq, buf - deq


def quantized_gossip_mix_ref(ws: torch.Tensor, x: torch.Tensor,
                             res: torch.Tensor, *, scheme: str,
                             group: int = 256, error_feedback: bool = True):
    """Error-feedback compressed multi-consensus (the JAX package's
    ``quantized_gossip_mix_ref``).  Per round r: buf = x + res; deq =
    dequant(quant(buf)); res <- buf - deq when ``error_feedback``; x <-
    ws[r] @ deq.  ws: (R, n, n); x, res: (n, D), D % group == 0.  Returns
    (mixed x, final residual) in the inputs' dtypes."""
    out = x.to(torch.float32)
    rs = res.to(torch.float32)
    for r in range(ws.shape[0]):
        buf = out + rs
        deq, err = quantize_dequantize_ref(buf, scheme=scheme, group=group)
        if error_feedback:
            rs = err
        out = ws[r].to(torch.float32) @ deq
    return out.to(x.dtype), rs.to(res.dtype)


def sparse_gossip_mix_ref(seg: torch.Tensor, w: torch.Tensor,
                          xs: torch.Tensor, xd: torch.Tensor,
                          num_segments: int) -> torch.Tensor:
    """Segment sum of weighted edge differences (the JAX package's
    ``sparse_gossip_mix_ref``): delta[s] = sum over e with seg[e] == s of
    w[e]·(xs[e] − xd[e]), in f32.  seg, w: (E,); xs, xd: (E, D) gathered
    endpoint states.  Padded edges carry w = 0 and add nothing.  Returns
    (num_segments, D) f32; ``index_add_`` takes the place of
    ``jax.ops.segment_sum``."""
    contrib = w[:, None].to(torch.float32) * (
        xs.to(torch.float32) - xd.to(torch.float32))
    out = torch.zeros((num_segments, xs.shape[1]), dtype=torch.float32,
                      device=xs.device)
    return out.index_add_(0, seg, contrib)


def staged_rows_ref(x: torch.Tensor, rows: torch.Tensor, lsrc: torch.Tensor,
                    ldst: torch.Tensor):
    """The endpoint states as the staged ``sparse_segment_mix`` reads them:
    the round's distinct rows x[rows] (U, D) taken once, and both endpoints
    of every edge gathered from them by local id.  Returns (xs, xd), equal
    to (x[src], x[dst]) when rows[lsrc] == src and rows[ldst] == dst."""
    staged = x[rows]
    return staged[lsrc.long()], staged[ldst.long()]


def staged_warp_edges_ref(offsets: torch.Tensor, nw: int) -> torch.Tensor:
    """How the staged ``sparse_segment_mix`` deals a round's S segments to
    the ``nw`` warps of a column tile: with S <= nw, warp k takes segment k
    alone; otherwise segment s goes to warp min(⌊(offsets[s] −
    offsets[0])·nw / E⌋, nw − 1), E = offsets[S] − offsets[0] (all to warp 0
    when E = 0), so a warp takes a run of whole segments whose first edges
    fall in its slice of E / nw edges.  Returns (nw,) int64: the edges each
    warp walks."""
    off = offsets.cpu().long()
    S, E = off.numel() - 1, int(off[-1] - off[0])
    if S <= nw:
        warp = torch.arange(S)
    elif E == 0:
        warp = torch.zeros(S, dtype=torch.long)
    else:
        warp = torch.clamp((off[:-1] - off[0]) * nw // E, max=nw - 1)
    return torch.zeros(nw, dtype=torch.long).index_add_(0, warp, off.diff())


def linear_recurrence_ref(a: torch.Tensor, b: torch.Tensor):
    """h_t = a_t·h_{t−1} + b_t along axis 1, h_{−1} = 0 (the JAX package's
    ``linear_recurrence_ref``).  a, b: (B, S, C), any float dtype, each step
    read as f32.  Returns (h_all (B, S, C) f32, h_last (B, C) f32).

    The product and the sum are two elementwise ops, each rounded to f32:
    the Hopper kernel rounds them the same way and is bit-equal to this."""
    B, S = a.shape[:2]
    h_all = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    h = torch.zeros((B,) + a.shape[2:], dtype=torch.float32, device=a.device)
    for t in range(S):
        h = a[:, t].to(torch.float32) * h + b[:, t].to(torch.float32)
        h_all[:, t] = h
    return h_all, h


def linear_recurrence_tiled_ref(a: torch.Tensor, b: torch.Tensor,
                                geometry: dict):
    """The Hopper kernel's walk on the CPU, as a
    :func:`repro_torch.kernels.linear_recurrence.launch_geometry` dict lays
    it out: grid (gx, B) blocks of ``cb`` channels each, the time axis in
    tiles of ``tile_t`` steps staged in a ring of ``stages`` stages, steps
    and channels past S and C staged as zeros (as TMA's and cp.async's zero
    fill leave them), the last tile's tail of S mod tile_t steps, and each
    step's product and sum as two f32 ops.  All blocks run at once here:
    they share nothing.  Bit-equal to :func:`linear_recurrence_ref`."""
    B, S, C = a.shape
    cb, T, stages = geometry["cb"], geometry["tile_t"], geometry["stages"]
    gx, gy = geometry["grid"]
    if gy != B or not (gx - 1) * cb < C <= gx * cb:
        raise ValueError(f"geometry {geometry} does not cover (B, C) = "
                         f"{(B, C)} once")
    tiles = -(-S // T)
    padded = []
    for x in (a, b):
        p = torch.zeros((B, tiles * T, gx * cb), dtype=x.dtype)
        p[:, :S, :C] = x
        padded.append(p.view(B, tiles, T, gx, cb))
    ring = torch.zeros((stages, 2, B, T, gx, cb), dtype=a.dtype)
    h = torch.zeros((B, gx, cb), dtype=torch.float32)
    h_all = torch.empty((B, S, C), dtype=torch.float32)
    for k in range(tiles):
        s = k % stages    # tile k - stages has been consumed: reuse its stage
        ring[s, 0], ring[s, 1] = padded[0][:, k], padded[1][:, k]
        for j in range(min(T, S - k * T)):
            h = (ring[s, 0, :, j].to(torch.float32) * h
                 + ring[s, 1, :, j].to(torch.float32))
            h_all[:, k * T + j] = h.reshape(B, gx * cb)[:, :C]
    return h_all, h.reshape(B, gx * cb)[:, :C].clone()


def masked_softmax_pv(s: torch.Tensor, mask: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """softmax over keys of the f32 scores ``s`` (B, J, G, Sq, Sk) with
    masked entries at the finite ``NEG_INF`` (a row with no valid key
    averages v), p cast to ``v.dtype`` before the product with v (B, Sk, J,
    hd) -> (B, Sq, J, G, hd).  The one plain masked softmax of the port:
    the model's attention (``models/attention.py``) uses it too."""
    s = torch.where(mask, s, torch.full((), NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bjgqk,bkjh->bqjgh", p.to(v.dtype), v)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) -> (B, Sq, H, hd), query
    head h reading KV head h // (H / KV) (the JAX package's
    ``attention_ref``).  Scores q·k in the inputs' dtype, then f32, divided
    by √hd; key k is masked for row q when causal and k > q, or with a
    window when k <= q − window."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    s = torch.einsum("bqjgh,bkjh->bjgqk", qg, k).to(torch.float32)
    s = s / math.sqrt(hd)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    o = masked_softmax_pv(s, mask, v)
    return o.reshape(B, Sq, H, hd)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kpos: torch.Tensor, pos: int, *,
                         window: int = 0) -> torch.Tensor:
    """q: (B, 1, J, G, hd); k, v: (B, C, J, hd); kpos: (C,) absolute
    positions (-1 = empty slot); pos: the query's position -> (B, 1, J·G,
    hd) (the JAX package's ``decode_attention_ref``).  Slot c is valid when
    kpos[c] >= 0, kpos[c] <= pos and, with a window, kpos[c] > pos −
    window."""
    B, _, J, G, hd = q.shape
    s = torch.einsum("bqjgh,bkjh->bjgqk", q, k).to(torch.float32)
    s = s / math.sqrt(hd)
    mask = (kpos >= 0) & (kpos <= pos)
    if window:
        mask &= kpos > pos - window
    o = masked_softmax_pv(s, mask, v)
    return o.reshape(B, 1, J * G, hd)


def decode_attention_split_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, kpos: torch.Tensor, pos: int,
                               *, window: int = 0, splits: int,
                               tile: int = 64) -> torch.Tensor:
    """The Hopper ``decode_attention`` kernel's arithmetic, for the tests:
    the C slots split into ``splits`` runs of ceil(C / splits); each run
    walks its slots in tiles of ``tile`` with an online softmax (f32 scores
    q·k·scale, invalid slots at ``NEG_INF``, m from ``NEG_INF``, l summed
    from the f32 p, p rounded to v's dtype before the product with v); then
    the runs' (m, l, acc) are combined in order: M = max m_r, L = Σ
    e^(m_r − M)·l_r, o = Σ e^(m_r − M)·acc_r / max(L, 1e-30).  Shapes as
    :func:`decode_attention_ref`."""
    B, _, J, G, hd = q.shape
    C = k.shape[1]
    dev = q.device
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32,
                         device=dev)
    qf = q.reshape(B, J, G, hd).to(torch.float32)
    valid = (kpos >= 0) & (kpos <= pos)
    if window:
        valid &= kpos > pos - window
    chunk = -(-C // splits)
    neg = torch.full((), NEG_INF, device=dev)
    states = []
    for c_begin in range(0, chunk * splits, chunk):
        m = torch.full((B, J, G), NEG_INF, device=dev)
        l = torch.zeros((B, J, G), device=dev)
        acc = torch.zeros((B, J, G, hd), device=dev)
        c_end = min(C, c_begin + chunk)
        for c0 in range(c_begin, c_end, tile):
            c1 = min(c_end, c0 + tile)
            kt = k[:, c0:c1].to(torch.float32)            # (B, t, J, hd)
            s = torch.einsum("bjgh,btjh->bjgt", qf, kt) * scale
            s = torch.where(valid[c0:c1], s, neg)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1)
            pv = torch.einsum("bjgt,btjh->bjgh", p.to(v.dtype).float(),
                              v[:, c0:c1].float())
            acc = alpha[..., None] * acc + pv
            m = m_new
        states.append((m, l, acc))
    M = torch.stack([m for m, _, _ in states]).amax(0)
    L = torch.zeros_like(M)
    out = torch.zeros_like(states[0][2])
    for m, l, acc in states:
        w = torch.exp(m - M)
        L = L + w * l
        out = out + w[..., None] * acc
    o = out / torch.clamp(L, min=1e-30)[..., None]
    return o.reshape(B, 1, J * G, hd).to(q.dtype)
