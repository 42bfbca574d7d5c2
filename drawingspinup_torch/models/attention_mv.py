"""Multi-view and cross-domain attention of the stage-2a MV-UNet
(counterpart of ``drawingspinup_tpu/models/attention_mv.py``, the math of
Wonder3D's ``mvdiffusion/models/transformer_mv2d.py``).

* MV attention: each view's queries attend over the keys and values of all
  ``num_views`` views of its group; the sparse variant attends over the
  front view's and its own.
* Joint (cross-domain) attention: the batch holds two halves (normals,
  colours) and each attends over both; its output projection starts at
  zero.
* ``BasicMVTransformerBlock``: LayerNorm → MV self-attention → [joint-mid]
  → cross-attention over the CLIP tokens → GEGLU feed-forward →
  [joint-last].

Tokens are (B, S, C). The folds are reshapes: the views of a group, or the
two halves, are stacked along the sequence, so one self-attention over the
folded sequence is exactly each query attending over the shared keys. The
attention core is ``F.scaled_dot_product_attention`` on f32 q/k/v, cast
back to the compute dtype, as JAX's ``_attention`` upcasts. Parameter
names are diffusers' (``to_q``, ``to_out.0``, ``ff.net.0.proj``, …), so a
Wonder3D checkpoint loads strictly.

Split batch (``RowSplit``, JAX's ``_mv_batch_sharding``): each rank of a
group holds some rows of the global batch. The folds that mix rows gather
the keys and values of every rank and keep their own queries; each query
row then attends over the rows its fold names by their global index, as
the one-rank path folds them. Everything else is per row.

Tracing (``core/profiling.py``): each core is a device-timed ``mv.attn``
span; each attention call counts its kind, ``mv.attn.views``,
``mv.attn.domains``, ``mv.attn.cross`` (``mv.attn.self`` without a fold).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from drawingspinup_torch.core import profiling
from drawingspinup_torch.parallel import mesh

# the counter of each kind of attention call
_COUNTERS = {"views": "mv.attn.views", "views_sparse": "mv.attn.views",
             "domains": "mv.attn.domains", "cross": "mv.attn.cross",
             None: "mv.attn.self"}


@dataclasses.dataclass
class RowSplit:
    """This rank's rows of a batch split over ``group``.

    rows: the global indices of this rank's rows, in its local order;
    gathered: the global indices of ``mesh.all_gather_rows``'s rows (every
    rank's ``rows`` in rank order); batch: the global batch size."""
    group: object
    rows: Sequence[int]
    gathered: Sequence[int]
    batch: int
    _index: Dict[Tuple[str, int, torch.device], torch.Tensor] = \
        dataclasses.field(default_factory=dict)

    def key_rows(self, fold: str, num_views: int,
                 device: torch.device) -> torch.Tensor:
        """(local rows, m) positions in the gathered rows of the key rows
        each local query row attends over, in the one-rank fold's order:
        'views' its group's ``num_views`` rows; 'views_sparse' its group's
        front row, then its own; 'domains' row i and row i + batch/2."""
        key = (fold, num_views, device)
        if key not in self._index:
            h2 = self.batch // 2
            sets: List[List[int]] = []
            for g in self.rows:
                first = g - g % num_views
                sets.append({
                    "views": list(range(first, first + num_views)),
                    "views_sparse": [first, g],
                    "domains": [g % h2, g % h2 + h2]}[fold])
            where = {g: i for i, g in enumerate(self.gathered)}
            self._index[key] = torch.tensor(
                [[where[g] for g in s] for s in sets], dtype=torch.long,
                device=device)
        return self._index[key]

    def gather_keys(self, t: torch.Tensor, fold: str,
                    num_views: int) -> torch.Tensor:
        """(local rows, S, C) keys (or keys ⊕ values) → (local rows,
        m·S, C): the rows each local query row attends over, gathered from
        the group and stacked along the sequence."""
        b, _, c = t.shape
        every = mesh.all_gather_rows(t, self.group)
        idx = self.key_rows(fold, num_views, t.device)
        return every[idx.reshape(-1)].reshape(b, -1, c)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` that normalises ``(x − mean) · rsqrt(var + eps)``.
    Torch's kernel folds the mean into a bias, ``x · rstd − mean · rstd``,
    which in f32 cancels where mean² ≫ variance, as at a 1×1 level where a
    group holds two values (``tests/test_torch_stage2a_pipeline.py::
    test_group_norm_centres_before_scaling`` measures both forms on the
    CPU). Statistics in f32 for
    16-bit inputs, in float64 for float64; the output in the input's
    dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wide = torch.float64 if x.dtype == torch.float64 else torch.float32
        g = x.to(wide).reshape(x.shape[0], self.num_groups, -1)
        centred = g - g.mean(-1, keepdim=True)
        var = centred.square().mean(-1, keepdim=True)
        y = (centred * torch.rsqrt(var + self.eps)).reshape(x.shape)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        y = y * self.weight.to(wide).reshape(shape) \
            + self.bias.to(wide).reshape(shape)
        return y.to(x.dtype)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   heads: int) -> torch.Tensor:
    """(B, Sq, C) × (B, Sk, C) → (B, Sq, C) multi-head attention, scale
    1/sqrt(C/heads), computed in f32 (float64 stays float64); the span
    ``mv.attn``, timed on the card under a profiler."""
    with profiling.span("mv.attn", device=True):
        dt = q.dtype
        wide = torch.float64 if dt == torch.float64 else torch.float32
        b, sq, c = q.shape
        sk = k.shape[1]
        d = c // heads
        q = q.reshape(b, sq, heads, d).transpose(1, 2).to(wide)
        k = k.reshape(b, sk, heads, d).transpose(1, 2).to(wide)
        v = v.reshape(b, sk, heads, d).transpose(1, 2).to(wide)
        out = F.scaled_dot_product_attention(q, k, v)
        return out.transpose(1, 2).reshape(b, sq, c).to(dt)


class Attention(nn.Module):
    """q/k/v/out projection attention (diffusers ``Attention`` layout:
    bias-free to_q, to_k, to_v; to_out.0 with bias)."""

    def __init__(self, dim: int, heads: int, cross_dim: Optional[int] = None,
                 zero_out: bool = False):
        super().__init__()
        self.heads = heads
        self.zero_out = zero_out
        kv = cross_dim or dim
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(kv, dim, bias=False)
        self.to_v = nn.Linear(kv, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                kv_fold: Optional[str] = None, num_views: int = 1,
                split: Optional[RowSplit] = None) -> torch.Tensor:
        """kv_fold: None | 'views' | 'views_sparse' | 'domains'. split:
        this rank's rows of a split batch; a fold then attends over the
        keys and values its rows name, gathered from the group."""
        profiling.count(_COUNTERS["cross" if context is not None
                                  else kv_fold])
        ctx = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        bv, s, c = q.shape
        if kv_fold is not None and split is not None:
            # one all-gather of K ⊕ V; the queries stay local
            kv = split.gather_keys(torch.cat([k, v], dim=-1), kv_fold,
                                   num_views)
            out = attention_core(q, kv[..., :c], kv[..., c:], self.heads)
        elif kv_fold == "views":
            # (B·V, S, C) → (B, V·S, C): every view of a group attends over
            # all its views' tokens
            b = bv // num_views
            out = attention_core(q.reshape(b, num_views * s, c),
                                 k.reshape(b, num_views * s, c),
                                 v.reshape(b, num_views * s, c),
                                 self.heads).reshape(bv, s, c)
        elif kv_fold == "domains":
            # batch = [half 0 | half 1], stacked along the sequence
            h2 = bv // 2
            out = attention_core(torch.cat([q[:h2], q[h2:]], dim=1),
                                 torch.cat([k[:h2], k[h2:]], dim=1),
                                 torch.cat([v[:h2], v[h2:]], dim=1),
                                 self.heads)
            out = torch.cat([out[:, :s], out[:, s:]], dim=0)
        else:
            if kv_fold == "views_sparse":
                b = bv // num_views
                sk = k.shape[1]

                def front(t):
                    return t.reshape(b, num_views, sk, c)[:, :1].expand(
                        b, num_views, sk, c).reshape(bv, sk, c)

                k = torch.cat([front(k), k], dim=1)
                v = torch.cat([front(v), v], dim=1)
            out = attention_core(q, k, v, self.heads)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate)           # the exact (erf) GELU, as JAX's


class GEGLUFeedForward(nn.Module):
    """diffusers FeedForward(activation_fn='geglu'): net.0 (GEGLU), net.1
    (dropout, inactive), net.2 (Linear)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for m in self.net:
            x = m(x)
        return x


class BasicMVTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, cross_dim: int = 768,
                 num_views: int = 6, multiview_attention: bool = True,
                 sparse_mv_attention: bool = False,
                 cd_attention_mid: bool = False,
                 cd_attention_last: bool = False):
        super().__init__()
        self.num_views = num_views
        self.fold = None
        if multiview_attention:
            self.fold = "views_sparse" if sparse_mv_attention else "views"
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads)
        self.cd_attention_mid = cd_attention_mid
        self.cd_attention_last = cd_attention_last
        if cd_attention_mid:
            self.norm_joint_mid = nn.LayerNorm(dim, eps=1e-5)
            self.attn_joint_mid = Attention(dim, heads, zero_out=True)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, cross_dim=cross_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = GEGLUFeedForward(dim)
        if cd_attention_last:
            self.norm_joint_last = nn.LayerNorm(dim, eps=1e-5)
            self.attn_joint_last = Attention(dim, heads, zero_out=True)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                split: Optional[RowSplit] = None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x), kv_fold=self.fold,
                           num_views=self.num_views, split=split)
        if self.cd_attention_mid:
            x = x + self.attn_joint_mid(self.norm_joint_mid(x),
                                        kv_fold="domains", split=split)
        x = x + self.attn2(self.norm2(x), context=context)
        x = x + self.ff(self.norm3(x))
        if self.cd_attention_last:
            x = x + self.attn_joint_last(self.norm_joint_last(x),
                                         kv_fold="domains", split=split)
        return x


class Conv1x1Tokens(nn.Module):
    """A 1×1 convolution applied to (B, S, C) tokens as a linear map. Its
    weight keeps the checkpoint's (O, I, 1, 1) conv shape."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 1, 1))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight[:, :, 0, 0], self.bias)


class TransformerMV2D(nn.Module):
    """Spatial transformer: GroupNorm → 1×1 proj_in → token blocks →
    proj_out + residual, on (N, C, H, W) maps."""

    def __init__(self, dim: int, heads: int, depth: int = 1,
                 cross_dim: int = 768, num_views: int = 6,
                 sparse_mv_attention: bool = False,
                 cd_attention_mid: bool = False,
                 cd_attention_last: bool = False):
        super().__init__()
        self.norm = GroupNorm(32, dim, eps=1e-6)
        self.proj_in = Conv1x1Tokens(dim, dim)
        self.transformer_blocks = nn.ModuleList([
            BasicMVTransformerBlock(
                dim, heads, cross_dim=cross_dim, num_views=num_views,
                sparse_mv_attention=sparse_mv_attention,
                cd_attention_mid=cd_attention_mid,
                cd_attention_last=cd_attention_last)
            for _ in range(depth)])
        self.proj_out = Conv1x1Tokens(dim, dim)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                split: Optional[RowSplit] = None) -> torch.Tensor:
        n, c, h, w = x.shape
        y = self.norm(x).permute(0, 2, 3, 1).reshape(n, h * w, c)
        y = self.proj_in(y)
        for blk in self.transformer_blocks:
            y = blk(y, context, split)
        y = self.proj_out(y).reshape(n, h, w, c).permute(0, 3, 1, 2)
        return y + x
