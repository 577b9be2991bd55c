"""ViT (counterpart of ``paddle_tpu/vision/models/vision_transformer.py``;
the baseline's fifth configuration names ViT-L/16): a transformer on
image patches.  Its attention is the port's composed
``scaled_dot_product_attention`` (fp32 inside), as the JAX model's is
the composed XLA form, not the flash kernel.

Multi-resolution input: :meth:`VisionTransformer._pos_embed_for`
resizes the position table to the input's patch grid (anti-aliased
bilinear, ``ops.nn_ops.interpolate``), a static function of the patch
count, so each resolution bucket's captured training step holds its
own resize, as each JAX bucket compiles its own.
"""

from __future__ import annotations

from ... import nn
from ...nn.layer import Layer
from ...ops import manipulation as M
from ...ops import nn_ops
from ._utils import layer_kw, refuse_pretrained


class PatchEmbed(Layer):
    def __init__(self, img_size=224, patch_size=16, in_chans=3,
                 embed_dim=768, **kw):
        super().__init__()
        self.num_patches = (img_size // patch_size) ** 2
        self.proj = nn.Conv2D(in_chans, embed_dim, patch_size,
                              stride=patch_size, **kw)

    def forward(self, x):
        x = M.flatten(self.proj(x), 2)          # B, E, N
        return M.transpose(x, [0, 2, 1])        # B, N, E


class MLP(Layer):
    def __init__(self, dim, hidden, drop=0.0, **kw):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, **kw)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden, dim, **kw)
        self.drop = nn.Dropout(drop)

    def forward(self, x):
        return self.drop(self.fc2(self.drop(self.act(self.fc1(x)))))


class Attention(Layer):
    def __init__(self, dim, num_heads, qkv_bias=True, attn_drop=0.0,
                 proj_drop=0.0, **kw):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qkv = nn.Linear(dim, dim * 3,
                             bias_attr=None if qkv_bias else False, **kw)
        self.proj = nn.Linear(dim, dim, **kw)
        self.proj_drop = nn.Dropout(proj_drop)

    def forward(self, x):
        b, n, c = x.shape
        qkv = M.reshape(self.qkv(x), [b, n, 3, self.num_heads,
                                      self.head_dim])
        out = nn_ops.scaled_dot_product_attention(
            qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        return self.proj_drop(self.proj(M.reshape(out, [b, n, c])))


class Block(Layer):
    def __init__(self, dim, num_heads, mlp_ratio=4.0, qkv_bias=True,
                 drop=0.0, attn_drop=0.0, epsilon=1e-6, **kw):
        super().__init__()
        dev = {"device": kw["device"]}
        self.norm1 = nn.LayerNorm(dim, epsilon=epsilon, **dev)
        self.attn = Attention(dim, num_heads, qkv_bias, attn_drop, drop,
                              **kw)
        self.norm2 = nn.LayerNorm(dim, epsilon=epsilon, **dev)
        self.mlp = MLP(dim, int(dim * mlp_ratio), drop, **kw)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class VisionTransformer(Layer):
    """``cls_token`` and ``pos_embed`` start from TruncatedNormal(0,
    0.02); ``amp.decorate`` O2 casts them with the other non-norm
    parameters, as the JAX ``decorate`` does."""

    def __init__(self, img_size=224, patch_size=16, in_chans=3,
                 num_classes=1000, embed_dim=768, depth=12, num_heads=12,
                 mlp_ratio=4.0, qkv_bias=True, drop_rate=0.0,
                 attn_drop_rate=0.0, epsilon=1e-6, *, device=None,
                 generator=None, **kwargs):
        super().__init__()
        kw = layer_kw(device, generator)
        self.num_classes = num_classes
        self.patch_embed = PatchEmbed(img_size, patch_size, in_chans,
                                      embed_dim, **kw)
        num_patches = self.patch_embed.num_patches
        trunc = nn.initializer.TruncatedNormal(std=0.02)
        self.cls_token = nn.initializer.create_parameter(
            [1, 1, embed_dim], default_initializer=trunc, **kw)
        self.pos_embed = nn.initializer.create_parameter(
            [1, num_patches + 1, embed_dim], default_initializer=trunc, **kw)
        self.pos_drop = nn.Dropout(drop_rate)
        self.blocks = nn.LayerList([
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, drop_rate,
                  attn_drop_rate, epsilon, **kw) for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, epsilon=epsilon,
                                 device=kw["device"])
        if num_classes > 0:
            self.head = nn.Linear(embed_dim, num_classes, **kw)

    def _pos_embed_for(self, n_patches: int):
        """The position table for an input of ``n_patches`` patches: the
        table itself at the build size, else its grid resized
        (anti-aliased bilinear, as ``jax.image.resize``) to the new
        square grid behind the unchanged class entry.  A grid that is
        not square raises ``ValueError``."""
        n_built = int(self.pos_embed.shape[1]) - 1
        if n_patches == n_built:
            return self.pos_embed
        cls_pe = self.pos_embed[:, :1]
        grid_pe = self.pos_embed[:, 1:]
        g_old = int(round(float(n_built) ** 0.5))
        g_new = int(round(float(n_patches) ** 0.5))
        if g_old * g_old != n_built or g_new * g_new != n_patches:
            raise ValueError(
                f"cannot interpolate position embeddings from "
                f"{n_built} to {n_patches} patches: non-square grid")
        e = grid_pe.shape[2]
        pe = M.transpose(M.reshape(grid_pe, [1, g_old, g_old, e]),
                         [0, 3, 1, 2])
        pe = nn_ops.interpolate(pe, size=[g_new, g_new], mode="bilinear",
                                align_corners=False)
        pe = M.reshape(M.transpose(pe, [0, 2, 3, 1]), [1, g_new * g_new, e])
        return M.concat([cls_pe, pe], axis=1)

    def forward(self, x):
        b = x.shape[0]
        x = self.patch_embed(x)
        cls = M.expand(self.cls_token, [b, 1, self.cls_token.shape[2]])
        pos = self._pos_embed_for(int(x.shape[1]))
        x = self.pos_drop(M.concat([cls, x], axis=1) + pos)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        if self.num_classes > 0:
            return self.head(x[:, 0])
        return x


def vit_b_16(pretrained=False, **kwargs):
    refuse_pretrained(pretrained)
    return VisionTransformer(patch_size=16, embed_dim=768, depth=12,
                             num_heads=12, **kwargs)


def vit_l_16(pretrained=False, **kwargs):
    refuse_pretrained(pretrained)
    return VisionTransformer(patch_size=16, embed_dim=1024, depth=24,
                             num_heads=16, **kwargs)
