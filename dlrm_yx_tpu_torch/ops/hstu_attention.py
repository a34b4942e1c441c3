"""HSTU's pointwise attention over jagged causal sequences, tiled by query
block, with a backward that recomputes the scores.

For each head h and each history, a query i attends to the keys j <= i of
its own history:

    A_i = sum_j SiLU(q_i . k_j + rab_ij) / N * v_j,
    rab_ij = pos_w[N - 1 - (i - j)] + time_w[bucket(t_i - t_j)],
    bucket(x) = min(floor(ln(max(|x|, 1)) / 0.301), num_buckets),

N the configuration's longest history (a constant, not the batch's
longest), pos_w [2N - 1] and time_w [num_buckets + 1] one layer's tables,
shared by the heads. No softmax: torch's SDPA and flex attention always
apply one, so neither computes this.

The layout is the batch's: T tokens, histories back to back
(``data.batch.SeqBatch``). Since a history holds at most N events, the
keys of query t lie in the N tokens t - N + 1 .. t: on the token axis this
is a causal sliding window of N, and a key of another (earlier) history
in that window is masked. The window's slots are indexed delta = 0..N-1
(key t - N + 1 + delta; delta = N - 1 is the query itself), so
i - j = N - 1 - delta and the position bias of a slot is pos_w[delta],
one [N] vector for every query. ``jagged_context`` works out, once a step
for every layer, each slot's time bucket, num_buckets + 1 where the slot
is masked ([T, N] uint8).

A query block of Q tokens (``block``) takes the keys of W = Q + N - 1
tokens rounded up to 8 (``window``; K and V padded with N - 1 zero rows in
front and zeros after): one [H, Q, W] product a block, whose band r <= w
<= r + N - 1 (an ``as_strided`` view of row stride W + 1) holds each
query's N slots. A [Q, W] bias, the block's band written into a buffer
whose two triangles stay -1e4, is added to the whole product (a masked
slot, and every slot off the band, gets -1e4, so SiLU and its derivative
give exactly 0 there), the product is SiLU'd in place, and times V gives
the block's output: every element-wise pass runs over whole aligned rows.
Nothing ever holds a step's [B, H, N, N] scores: the largest tensor is a
block's [H, Q, W]. The backward recomputes each block's scores; the
position bias's gradient is the band's column sums and the time bias's
the differences of each row's prefix sums at its bucket edges (along a
row the buckets never rise: ``jagged_context`` finds the edges once a
step), so neither takes a scatter or atomics.

The products run in the compute dtype of q, k and v (bf16 on the card,
f32 in the tests), the bias in that dtype; K's, V's and both tables'
gradients accumulate in f32. The work is counted by ``scores``: a layer
computes H * T * W scores, of which H * sum L(L + 1) / 2 are live (the
rest padded: the band's masked slots, the triangles and the rounding).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MASKED_BIAS = -1e4  # a masked slot's bias: SiLU and SiLU' of it are exactly 0
BUCKET_SCALE = 0.301  # the reference's log base: ln(x) / 0.301


class JaggedContext(NamedTuple):
    """What every layer's attention shares in a step: ``bucket`` [T, N]
    uint8, each query's slot delta's time bucket (``num_buckets + 1`` where
    the slot's key is not in the query's history); ``edges`` [T,
    num_buckets + 3] int64, where each bucket's run of slots begins and
    ends in a query's row (``bucket_edges``); ``max_len`` N; ``block`` Q."""

    bucket: torch.Tensor
    edges: torch.Tensor
    max_len: int
    block: int


def token_positions(offsets: torch.Tensor, tokens: int) -> torch.Tensor:
    """Each token's position in its history [T] int64, from the offsets
    [S + 1] (padded histories empty, starting at T)."""
    t = torch.arange(tokens, device=offsets.device)
    off = offsets.long()
    seq = torch.searchsorted(off[1:], t, right=True)
    return t - off.index_select(0, seq)


def time_buckets(dt: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """The reference's bucket of a time gap: floor(ln(max(|dt|, 1)) / 0.301)
    in f32, clamped to [0, num_buckets] (int64)."""
    b = (torch.log(dt.abs().clamp(min=1).float()) / BUCKET_SCALE).long()
    return b.clamp(0, num_buckets)


def _slots(x: torch.Tensor, rows: int, n: int) -> torch.Tensor:
    """The [rows, n] view of a 1-D ``x`` whose row r is x[r : r + n]."""
    return x.as_strided((rows, n), (x.stride(0), x.stride(0)))


def bucket_edges(bucket: torch.Tensor, top: int) -> torch.Tensor:
    """[Q, top + 2] int64 of rows ``bucket`` [Q, N] whose buckets do not
    rise along a row: column 0 holds N and column b + 1 the first slot whose
    bucket is at most b, so bucket b's slots are [edges[b + 1], edges[b])."""
    rev = bucket.flip(1).to(torch.int32)  # ascending along each row
    up_to = torch.arange(top + 1, dtype=torch.int32, device=bucket.device)
    at_most = torch.searchsorted(rev, up_to.expand(rev.shape[0], -1).contiguous(), right=True)
    n = bucket.shape[1]
    return torch.cat([torch.full_like(at_most[:, :1], n), n - at_most], dim=1)


def jagged_context(offsets: torch.Tensor, times: torch.Tensor, max_len: int,
                   num_buckets: int, block: int) -> JaggedContext:
    """The step's ``JaggedContext`` from its offsets [S + 1] and timestamps
    [T] (int64), a query block at a time. Along a query's row the keys come
    later and later in its history, so its gaps, and its buckets, never
    rise; the masked slots before them take the highest bucket."""
    tokens = times.shape[0]
    n = max_len
    pos = token_positions(offsets, tokens)
    t_pad = torch.cat([times.new_zeros(n - 1), times])
    delta = torch.arange(n, device=times.device)
    bucket = torch.empty((tokens, n), dtype=torch.uint8, device=times.device)
    edges = torch.empty((tokens, num_buckets + 3), dtype=torch.int64, device=times.device)
    for q0 in range(0, tokens, block):
        q1 = min(q0 + block, tokens)
        keys = _slots(t_pad[q0:q1 + n - 1], q1 - q0, n)
        b = time_buckets(times[q0:q1, None] - keys, num_buckets)
        live = delta[None, :] >= (n - 1) - pos[q0:q1, None]
        bucket[q0:q1] = torch.where(live, b, num_buckets + 1)
        edges[q0:q1] = bucket_edges(bucket[q0:q1], num_buckets + 1)
    return JaggedContext(bucket, edges, n, block)


def window(block: int, max_len: int) -> int:
    """The keys a query block of ``block`` tokens reads: its Q + N - 1,
    rounded up to 8 so that every row of a block's products starts 16-byte
    aligned (the GEMMs' vectorised paths)."""
    return -(-(block + max_len - 1) // 8) * 8


def scores(lengths: torch.Tensor, tokens: int, heads: int, max_len: int, block: int):
    """(live, computed) scores of one layer's forward: a 0-dim int64 device
    tensor and an int; ``lengths`` [S] the histories' lengths."""
    l = lengths.long()
    live = (l * (l + 1) // 2).sum() * heads
    return live, heads * tokens * window(block, max_len)


def _band(buf: torch.Tensor, n: int) -> torch.Tensor:
    """The [..., Q, N] band of a [..., Q, W] block: row r's slots r .. r +
    N - 1 (W >= Q + N - 1)."""
    q, w = buf.shape[-2:]
    lead = buf.shape[:-2]
    return buf.as_strided(lead + (q, n), tuple(q * w for _ in lead) + (w + 1, 1),
                          buf.storage_offset())


def _padded(x: torch.Tensor, n: int, length: int) -> torch.Tensor:
    """[T, H, d] -> [H, length, d]: N - 1 zero rows in front, zeros after."""
    t, h, d = x.shape
    out = x.new_zeros((h, length, d))
    out[:, n - 1:n - 1 + t] = x.transpose(0, 1)
    return out


def _bias(ctx: JaggedContext, pos_w: torch.Tensor, time_ext: torch.Tensor, q0: int,
          q1: int) -> torch.Tensor:
    """The block's [Q, N] bias in the compute dtype: the time table
    (with the masked bucket's -1e4 at its end) at each slot's bucket, plus
    the position table's first N entries."""
    return time_ext[ctx.bucket[q0:q1].long()] + pos_w[None, :ctx.max_len]


class _Tiles:
    """What a call's blocks share: K and V padded to every block's window,
    the tables in the compute dtype, and the [Q, W] bias of a block, -1e4
    off its band (its triangles: keys after the query or past N - 1
    before it), whose band each block refills."""

    def __init__(self, q, k, v, pos_w, time_w, ctx: JaggedContext):
        t = q.shape[0]
        n, blk = ctx.max_len, ctx.block
        self.w = window(blk, n)
        self.qh = q.transpose(0, 1)
        self.kp = _padded(k, n, t + self.w - blk)
        self.vp = _padded(v, n, t + self.w - blk)
        self.pos = pos_w.to(q.dtype)
        self.time_ext = torch.cat([time_w, time_w.new_full((1,), MASKED_BIAS)]).to(q.dtype)
        self.bias = q.new_full((blk, self.w), MASKED_BIAS)
        self.ctx = ctx

    def scores(self, q0: int, out: torch.Tensor) -> torch.Tensor:
        """``out`` [H, Q, W] <- the block's scores plus its bias (z)."""
        q1 = q0 + self.ctx.block
        _band(self.bias, self.ctx.max_len).copy_(_bias(self.ctx, self.pos, self.time_ext, q0,
                                                       q1))
        torch.bmm(self.qh[:, q0:q1], self.kp[:, q0:q0 + self.w].transpose(1, 2), out=out)
        for head in out:  # a head at a time: a vectorised add (a broadcast one is not)
            head.add_(self.bias)
        return out


def _bucket_sums(d_bias: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """[num_buckets + 2] f32: ``d_bias`` [Q, N] summed by bucket, each
    row's bucket runs (``bucket_edges``) read off its prefix sums (in f64,
    so the differences keep f32's precision): no scatter."""
    prefix = d_bias.cumsum(dim=1, dtype=torch.float64)
    at = prefix.gather(1, (edges - 1).clamp(min=0))
    at = torch.where(edges > 0, at, 0.0)
    return (at[:, :-1] - at[:, 1:]).sum(dim=0).float()


class _JaggedPointwiseAttention(torch.autograd.Function):

    @staticmethod
    def forward(fctx, q, k, v, pos_w, time_w, ctx: JaggedContext):
        t, h, _ = q.shape
        n, blk = ctx.max_len, ctx.block
        tiles = _Tiles(q, k, v, pos_w, time_w, ctx)
        s_buf = q.new_empty((h, blk, tiles.w))
        out = q.new_empty((h, t, v.shape[2]))
        for q0 in range(0, t, blk):
            p = torch.nn.functional.silu(tiles.scores(q0, s_buf), inplace=True)
            out[:, q0:q0 + blk] = torch.bmm(p, tiles.vp[:, q0:q0 + tiles.w])
        fctx.save_for_backward(q, k, v, pos_w, time_w)
        fctx.jagged = ctx
        return out.mul_(1.0 / n).transpose(0, 1)

    @staticmethod
    def backward(fctx, d_out):
        q, k, v, pos_w, time_w = fctx.saved_tensors
        ctx = fctx.jagged
        t, h, dq = q.shape
        dv = v.shape[2]
        n, blk = ctx.max_len, ctx.block
        nb = time_w.shape[0]
        tiles = _Tiles(q, k, v, pos_w, time_w, ctx)
        w = tiles.w
        # the 1 / N of the forward, taken into the incoming gradient once
        go = (d_out.to(torch.float32) * (1.0 / n)).to(q.dtype).transpose(0, 1).contiguous()
        s_buf, p_buf, ds_buf = (q.new_empty((h, blk, w)) for _ in range(3))
        d_q = q.new_empty((h, t, dq))
        d_kp = torch.zeros((h, t + w - blk, dq), dtype=torch.float32, device=q.device)
        d_vp = torch.zeros((h, t + w - blk, dv), dtype=torch.float32, device=q.device)
        d_pos = torch.zeros(pos_w.shape[0], dtype=torch.float32, device=q.device)
        d_time = torch.zeros(nb + 1, dtype=torch.float32, device=q.device)
        for q0 in range(0, t, blk):
            q1 = q0 + blk
            qb, gb = tiles.qh[:, q0:q1], go[:, q0:q1]
            kw, vw = tiles.kp[:, q0:q0 + w], tiles.vp[:, q0:q0 + w]
            z = tiles.scores(q0, s_buf)
            torch.ops.aten.silu.out(z, out=p_buf)
            d_vp[:, q0:q0 + w] += torch.bmm(p_buf.transpose(1, 2), gb)
            torch.bmm(gb, vw.transpose(1, 2), out=ds_buf)
            # dZ = dP * SiLU'(z) in place: 0 wherever the bias masked the slot
            torch.ops.aten.silu_backward.grad_input(ds_buf, z, grad_input=ds_buf)
            d_bias = _band(ds_buf.sum(dim=0, dtype=torch.float32), n)
            d_pos[:n] += d_bias.sum(dim=0)
            d_time += _bucket_sums(d_bias, ctx.edges[q0:q1])
            d_q[:, q0:q1] = torch.bmm(ds_buf, kw)
            d_kp[:, q0:q0 + w] += torch.bmm(ds_buf.transpose(1, 2), qb)
        return (d_q.transpose(0, 1), d_kp[:, n - 1:n - 1 + t].transpose(0, 1).to(q.dtype),
                d_vp[:, n - 1:n - 1 + t].transpose(0, 1).to(q.dtype), d_pos.to(pos_w.dtype),
                d_time[:nb].to(time_w.dtype), None)


def hstu_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos_w: torch.Tensor,
                   time_w: torch.Tensor, ctx: JaggedContext) -> torch.Tensor:
    """[T, H, dv] attention of q, k [T, H, dqk] and v [T, H, dv] (one
    dtype, the compute dtype) under ``ctx``, with the layer's position
    table pos_w [2N - 1] and time table time_w [num_buckets + 1] (f32);
    differentiable in all five. T must be a multiple of ``ctx.block``."""
    if q.shape[0] % ctx.block:
        raise ValueError(f"{q.shape[0]} tokens are not a multiple of the block {ctx.block}")
    return _JaggedPointwiseAttention.apply(q, k, v, pos_w, time_w, ctx)
