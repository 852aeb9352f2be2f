"""Vision Transformer (port of fastvision_tpu/models/classification/vit.py).

Pre-LN encoder blocks, learned position embeddings, a CLS token and its
head; no dropout. What the JAX package's flax modules fix and torch's
defaults would not:

  - LayerNorm epsilon 1e-6 (flax's; torch's default is 1e-5);
  - GELU in its tanh form (flax ``nn.gelu``; torch's default is exact);
  - attention as flax ``MultiHeadDotProductAttention``: q, k and v
    projections with biases, softmax(q k^T / sqrt(head_dim)) v, an output
    projection. Here q, k and v are one ``attn.qkv`` Linear ([3 dim, dim],
    q then k then v, heads in order inside each) and the output is
    ``attn.proj`` (timm's names); `models.import_jax.vit_state_dict_from_jax`
    reshapes flax's [dim, heads, head_dim] and [heads, head_dim, dim]
    kernels into them. The product runs in
    ``F.scaled_dot_product_attention``: XLA ran it in the JAX package,
    no Pallas kernel;
  - the head runs in float32 under a bf16 autocast, as the JAX package
    runs it in float32 under bf16 compute.

``including_top=True`` takes NHWC images [B, H, W, 3] -> logits;
``including_top=False`` takes NCHW and returns the tokens [B, 1 + HW / p^2,
dim], CLS first.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.layers import init_weights_

LN_EPS = 1e-6


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        q, k, v = self.qkv(x).reshape(b, t, 3, self.heads, d // self.heads).permute(2, 0, 3, 1, 4)
        y = F.scaled_dot_product_attention(q, k, v)  # [B, heads, T, head_dim]
        return self.proj(y.transpose(1, 2).reshape(b, t, d))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    """``image_size`` sets the position embedding's length ((image_size /
    patch)^2 + 1), which flax infers from the first input. ``generator``
    seeds the initial weights: flax's lecun-normal for the patch embedding
    and every Linear, position embedding N(0, 0.02), CLS token 0."""

    def __init__(self, num_classes: int = 1000, patch: int = 16, dim: int = 384,
                 depth: int = 12, heads: int = 6, mlp_ratio: int = 4,
                 including_top: bool = True, image_size: int = 224,
                 generator: torch.Generator | None = None):
        super().__init__()
        if image_size % patch:
            raise ValueError(f"image_size {image_size} not divisible by patch size {patch}")
        self.patch, self.dim, self.including_top = patch, dim, including_top
        self.patch_embed = nn.Conv2d(3, dim, patch, patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, (image_size // patch) ** 2 + 1, dim))
        self.blocks = nn.Sequential(*(EncoderBlock(dim, heads, mlp_ratio) for _ in range(depth)))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        if including_top:
            self.head = nn.Linear(dim, num_classes)
        init_weights_(self, generator)
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.including_top:
            x = x.permute(0, 3, 1, 2)
        b, _, h, w = x.shape
        if h % self.patch or w % self.patch:
            raise ValueError(f"input {h}x{w} not divisible by patch size {self.patch}")
        x = self.patch_embed(x).flatten(2).transpose(1, 2)  # [B, HW / p^2, dim], (h, w) order
        x = torch.cat([self.cls_token.expand(b, 1, self.dim).to(x.dtype), x], dim=1)
        x = self.norm(self.blocks(x + self.pos_embed.to(x.dtype)))
        if not self.including_top:
            return x
        with torch.autocast(x.device.type, enabled=False):
            return self.head(x[:, 0].float())


def vit_tiny_patch16(num_classes: int = 1000, **kw) -> ViT:
    return ViT(num_classes=num_classes, dim=192, depth=12, heads=3, **kw)


def vit_small_patch16(num_classes: int = 1000, **kw) -> ViT:
    return ViT(num_classes=num_classes, dim=384, depth=12, heads=6, **kw)


def vit_base_patch16(num_classes: int = 1000, **kw) -> ViT:
    return ViT(num_classes=num_classes, dim=768, depth=12, heads=12, **kw)
