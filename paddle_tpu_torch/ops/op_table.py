"""The op sweep's table — the port's copy of the ``ops.*`` entries of
``paddle_tpu/ops/op_table.py`` (public signature, input shapes and numeric
domains, attributes), in the same order, and the cases that complete it:

* :data:`OPS` — the differentiable ops: the JAX table's ``ops.*`` entries,
  then the port's own (ops of the registry the JAX table does not reach);
* :data:`F_OPS` — the ``nn.functional`` entries: the JAX table's ``F.*``
  entries whose functional the port has, in its order, then the port's own
  (the registry ops they miss, and the options where PyTorch's function of
  the same name means something else); a list apart, so that the ``ops.*``
  sweep keeps its two halves;
* :data:`NONDIFF` — ops with integer or boolean outputs, or none to
  differentiate: creation, search, logic and index ops;
* :data:`LOWP` — the JAX table's ops with no low-precision run (its fp32-only
  decompositions).

:func:`draw` makes an input from a seeded ``numpy.random.RandomState`` as the
JAX package's own sweep does (``tests/test_op_grad_sweep.py``), and
:func:`scaled` grows an entry's shapes by a factor ``k`` (every axis longer
than 1, and the index domains with them) for the card's sweep, where
:data:`SIZE_CAP` bounds an input's elements and :data:`K_OF` fixes ``k``
for the ops whose work grows faster than their inputs. :func:`resolve`
gives the port's callable of an entry, and :func:`registry_ops_called`
the registry ops a sweep reached.
"""
from __future__ import annotations

import contextlib

import numpy as np

from . import dispatch

__all__ = ["OPS", "F_OPS", "NONDIFF", "LOWP", "draw", "scaled", "resolve",
           "differentiable_inputs", "LINALG", "registry_ops_called"]

OPS = []
F_OPS = []
NONDIFF = []


def _op(api, inputs, kwargs=None, only=None, table=OPS):
    table.append(dict(api=api, inputs=inputs, kwargs=kwargs or {},
                      only=only))


S = (3, 4)
V = (6,)
M33 = (3, 3)

# ------------------------------------------------- the JAX table's entries --
for name in ["abs", "asinh", "atan", "cos", "cosh", "erf", "exp",
             "expm1", "neg", "sin", "sinh", "square", "tan", "tanh"]:
    _op(f"ops.{name}", ((S, "f"),))
_op("ops.abs", ((S, "fp"),))
_op("ops.atan2", ((S, "fp"), (S, "fp")))
for name in ["log", "log2", "log10", "log1p", "sqrt", "rsqrt", "reciprocal",
             "digamma", "lgamma"]:
    _op(f"ops.{name}", ((S, "fp"),))
_op("ops.acos", ((S, "unit"),))
_op("ops.asin", ((S, "unit"),))
_op("ops.atanh", ((S, "unit"),))
_op("ops.acosh", ((S, "gt1"),))
_op("ops.logit", ((S, "unit"),), kwargs=dict(eps=0.0))
_op("ops.erfinv", ((S, "unit"),))
_op("ops.cumprod", ((V, "fp"),), kwargs=dict(dim=0))
_op("ops.logsumexp", ((S, "f"),))
_op("ops.logaddexp", ((S, "f"), (S, "f")))
_op("ops.add", ((S, "f"), (S, "f")))
_op("ops.subtract", ((S, "f"), (S, "f")))
_op("ops.multiply", ((S, "f"), (S, "f")))
_op("ops.divide", ((S, "f"), (S, "fp")))
_op("ops.maximum", ((S, "f"), (S, "f2")))
_op("ops.minimum", ((S, "f"), (S, "f2")))
_op("ops.fmax", ((S, "f"), (S, "f2")))
_op("ops.fmin", ((S, "f"), (S, "f2")))
_op("ops.pow", ((S, "fp"), (S, "fp")))
_op("ops.hypot", ((S, "fp"), (S, "fp")))
_op("ops.copysign", ((S, "fp"), (S, "fp")), only=(0,))
_op("ops.lerp", ((S, "f"), (S, "f"), (S, "unit")))
_op("ops.nextafter", ((S, "f"), (S, "f")), only=())
_op("ops.sum", ((S, "f"),))
_op("ops.sum", ((S, "f"),), kwargs=dict(axis=1))
_op("ops.mean", ((S, "f"),))
_op("ops.mean", ((S, "f"),), kwargs=dict(axis=0, keepdim=True))
_op("ops.prod", ((S, "fp"),))
_op("ops.max", ((S, "funique"),))
_op("ops.min", ((S, "funique"),))
_op("ops.amax", ((S, "funique"),))
_op("ops.nansum", ((S, "f"),))
_op("ops.nanmean", ((S, "f"),))
_op("ops.std", ((S, "f"),))
_op("ops.var", ((S, "f"),))
_op("ops.trace", ((S, "f"),))
_op("ops.cumsum", ((S, "f"),), kwargs=dict(axis=1))
_op("ops.median", ((V, "funique"),))
_op("ops.quantile", ((V, "funique"),), kwargs=dict(q=0.5))
_op("ops.matmul", ((S, "f"), ((4, 5), "f")))
_op("ops.matmul", ((S, "f"), (S, "f")), kwargs=dict(transpose_y=True))
_op("ops.bmm", (((2, 3, 4), "f"), ((2, 4, 3), "f")))
_op("ops.dot", ((V, "f"), (V, "f")))
_op("ops.mv", ((S, "f"), ((4,), "f")))
_op("ops.outer", ((V, "f"), ((4,), "f")))
_op("ops.inner", ((S, "f"), ((5, 4), "f")))
_op("ops.kron", (((2, 2), "f"), ((2, 2), "f")))
_op("ops.addmm", ((M33, "f"), (M33, "f"), (M33, "f")))
_op("ops.inverse", ((M33, "spd"),))
_op("ops.det", ((M33, "spd"),))
_op("ops.slogdet", ((M33, "spd"),), only=(0,))
_op("ops.cholesky", ((M33, "spd"),))
_op("ops.solve", ((M33, "spd"), (M33, "f")))
_op("ops.triangular_solve", ((M33, "trilpd"), (M33, "f")))
_op("ops.matrix_power", ((M33, "f"),), kwargs=dict(n=2))
_op("ops.multi_dot", (((3, 4), "f"), ((4, 2), "f")))
_op("ops.einsum_ij_jk", (((3, 4), "f"), ((4, 2), "f")))
_op("ops.pinv", ((M33, "spd"),))
_op("ops.reshape", ((S, "f"),), kwargs=dict(shape=[4, 3]))
_op("ops.transpose", ((S, "f"),), kwargs=dict(perm=[1, 0]))
_op("ops.flatten", (((2, 3, 4), "f"),))
_op("ops.squeeze", (((3, 1, 4), "f"),), kwargs=dict(axis=1))
_op("ops.unsqueeze", ((S, "f"),), kwargs=dict(axis=0))
_op("ops.concat2", ((S, "f"), (S, "f")), kwargs=dict(axis=0))
_op("ops.stack2", ((S, "f"), (S, "f")), kwargs=dict(axis=0))
_op("ops.split_first", (((4, 4), "f"),), kwargs=dict(num_or_sections=2))
_op("ops.tile", ((S, "f"),), kwargs=dict(repeat_times=[2, 1]))
_op("ops.expand", (((1, 4), "f"),), kwargs=dict(shape=[3, 4]))
_op("ops.flip", ((S, "f"),), kwargs=dict(axis=[0]))
_op("ops.roll", ((S, "f"),), kwargs=dict(shifts=1))
_op("ops.rot90", ((S, "f"),))
_op("ops.moveaxis", (((2, 3, 4), "f"),), kwargs=dict(source=0, destination=2))
_op("ops.tril", ((S, "f"),))
_op("ops.triu", ((S, "f"),))
_op("ops.diag", ((V, "f"),))
_op("ops.diagonal", ((M33, "f"),))
_op("ops.diagflat", ((V, "f"),))
_op("ops.pad2d", ((S, "f"),), kwargs=dict(pad=[1, 1, 0, 2]))
_op("ops.gather", ((S, "f"), ((2,), "int:3")), kwargs=dict(axis=0))
_op("ops.index_select", ((S, "f"), ((2,), "int:3")), kwargs=dict(axis=0))
_op("ops.take_along_axis", ((S, "f"), ((3, 1), "int:4")), kwargs=dict(axis=1))
_op("ops.gather_nd", ((S, "f"), ((2, 2), "int:3")))
_op("ops.masked_fill", ((S, "f"), (S, "bool")), kwargs=dict(value=0.5))
_op("ops.where3", ((S, "bool"), (S, "f"), (S, "f")))
_op("ops.clip", ((S, "f"),), kwargs=dict(min=-0.5, max=0.5))
_op("ops.repeat_interleave", ((V, "f"),), kwargs=dict(repeats=2))
_op("ops.index_sample", ((S, "f"), ((3, 2), "int:4")))
_op("ops.getitem_slice", ((S, "f"),))
_op("ops.multiplex2", ((S, "f"), (S, "f")))
_op("ops.stanh", ((S, "f"),))
_op("ops.where", ((S, "bool"), (S, "f"), (S, "f2")), only=(1, 2))
_op("ops.sort", ((V, "funique"),))
_op("ops.topk", ((V, "funique"),), kwargs=dict(k=3))
_op("ops.scatter", (((5, 3), "f"), ((2,), "int:5"), ((2, 3), "f2")),
    only=(0, 2))
_op("ops.put_along_axis", (((4, 3), "f"), ((2, 3), "int:4"), ((2, 3), "f2")),
    kwargs=dict(axis=0), only=(0, 2))
_op("ops.fill_diagonal_", ((S, "f"),), kwargs=dict(value=0.5))
_op("ops.pad", ((S, "f"),), kwargs=dict(pad=[1, 1, 0, 2], mode="constant"))
_op("ops.frac", ((S, "f"),))
_op("ops.nan_to_num", ((S, "f"),))
_op("ops.deg2rad", ((S, "f"),))
_op("ops.rad2deg", ((S, "f"),))
_op("ops.cov", (((3, 6), "f"),))
_op("ops.dist", ((S, "fnz"), (S, "f2")))
_op("ops.qr", (((3, 3), "spd"),))
_op("ops.eigh", (((3, 3), "spd"),))
_op("ops.cholesky_solve", (((3, 2), "f"), ((3, 3), "trilpd")))

#: the number of the JAX table's entries above
N_JAX = len(OPS)

# ------------------------------------------ registry ops the JAX table misses --
_op("ops.floor_divide", ((S, "f"), (S, "fp")), only=())
_op("ops.remainder", ((S, "f"), (S, "fp")))
_op("ops.heaviside", ((S, "f"), (S, "f2")), only=())
_op("ops.sign", ((S, "fnz"),))
_op("ops.ceil", ((S, "f"),))
_op("ops.floor", ((S, "f"),))
_op("ops.round", ((S, "f"),))
_op("ops.trunc", ((S, "f"),))
_op("ops.i0", ((S, "f"),))
_op("ops.i0e", ((S, "f"),))
_op("ops.i1", ((S, "f"),))
_op("ops.i1e", ((S, "f"),))
_op("ops.angle", ((S, "fnz"),), only=())
_op("ops.conj", ((S, "f"),))
_op("ops.real", ((S, "f"),))
_op("ops.imag", ((S, "f"),), only=())
_op("ops.min", ((S, "funique"),), kwargs=dict(axis=1))
_op("ops.max", ((S, "funique"),), kwargs=dict(axis=0, keepdim=True))
_op("ops.cummax", ((S, "funique"),), kwargs=dict(axis=1))
_op("ops.cummin", ((S, "funique"),), kwargs=dict(axis=0))
_op("ops.logcumsumexp", ((S, "f"),), kwargs=dict(axis=1))
_op("ops.diff", ((S, "f"),), kwargs=dict(axis=1))
_op("ops.renorm", ((S, "f"),), kwargs=dict(p=2.0, axis=0, max_norm=0.5))
_op("ops.tensordot", ((S, "f"), ((4, 5), "f")), kwargs=dict(axes=1))
_op("ops.cross", (((3, 4), "f"), ((3, 4), "f2")), kwargs=dict(axis=0))
_op("ops.scale", ((S, "f"),), kwargs=dict(scale=2.0, bias=0.5))
_op("ops.norm", ((S, "f"),))
_op("ops.norm", ((S, "f"),), kwargs=dict(p=1.0, axis=1))
_op("ops.norm_fro", ((S, "f"),))
_op("ops.cond", ((M33, "spd"),))
_op("ops.lstsq", (((4, 3), "f"), ((4, 2), "f2")))
_op("ops.svdvals", ((M33, "spd"),))
_op("ops.eigvalsh", ((M33, "spd"),))
_op("ops.as_real_complex", ((S, "f"),))
_op("ops.unstack", ((S, "f"),), kwargs=dict(axis=0))
_op("ops.slice", ((S, "f"),), kwargs=dict(axes=[1], starts=[1], ends=[3]))
_op("ops.index_add", ((S, "f"), ((2,), "int:3"), ((2, 4), "f2")),
    kwargs=dict(axis=0), only=(0, 2))
_op("ops.index_put", ((S, "f"), ((2,), "int:3"), ((2, 4), "f2")),
    only=(0, 2))
_op("ops.index_put_add", ((S, "f"), ((2,), "int:3"), ((2, 4), "f2")),
    only=(0, 2))
_op("ops.setitem_rows", ((S, "f"), ((2, 4), "f2")))
_op("ops.scatter_nd_add", ((S, "f"), ((2, 2), "int:3"), ((2,), "f2")),
    only=(0, 2))
_op("ops.masked_select", ((S, "f"), (S, "bool")))
_op("ops.zeros_like", ((S, "f"),))
_op("ops.assign", ((S, "f"),))
_op("ops.cast_f64", ((S, "f"),))
_op("ops.increment_copy", ((S, "f"),))
_op("ops.shard_index", ((S, "int:20"),),
    kwargs=dict(index_num=20, nshards=2, shard_id=1), only=())
_op("ops.histogram", ((V, "f"),), kwargs=dict(bins=4, min=-1, max=1),
    only=())
_op("ops.gcd", ((S, "int:12"), (S, "int:12")), only=())
_op("ops.lcm", ((S, "int:12"), (S, "int:12")), only=())

# ------------------------------------ the JAX table's ``F.*`` entries --
def _f(api, inputs, kwargs=None, only=None):
    _op(api, inputs, kwargs, only, table=F_OPS)


for name in ["relu", "relu6", "elu", "selu", "celu", "gelu", "silu",
             "sigmoid", "softplus", "softsign", "mish", "tanhshrink",
             "log_sigmoid", "hardswish", "hardsigmoid", "leaky_relu",
             "hardtanh"]:
    _f(f"F.{name}", ((S, "fnz"),))
_f("F.softmax", ((S, "f"),))
_f("F.log_softmax", ((S, "f"),))
_f("F.softshrink", ((S, "fnz"),), kwargs=dict(threshold=0.1))
_f("F.hardshrink", ((S, "fnz"),), kwargs=dict(threshold=0.1))
_f("F.thresholded_relu", ((S, "fnz"),), kwargs=dict(threshold=0.3))
_f("F.prelu", ((S, "fnz"), ((1,), "unit")))
_f("F.glu", (((3, 4), "f"),))
_f("F.maxout", (((1, 4, 2, 2), "funique"),), kwargs=dict(groups=2))
_f("F.normalize", ((S, "fp"),))
_f("F.mse_loss", ((S, "f"), (S, "f")))
_f("F.l1_loss", ((S, "f"), (S, "gt1")))
_f("F.smooth_l1_loss", ((S, "f"), (S, "f2")), kwargs=dict(delta=0.5))
_f("F.huber_loss", ((S, "f"), (S, "f2")), kwargs=dict(delta=0.5))
_f("F.kl_div", ((S, "logunit"), (S, "unit")), only=(0,))
_f("F.binary_cross_entropy", ((S, "unit"), (S, "unit")), only=(0,))
_f("F.binary_cross_entropy_with_logits", ((S, "f"), (S, "unit")), only=(0,))
_f("F.cross_entropy_labels", (((4, 5), "f"), ((4, 1), "int:5")), only=(0,))
_f("F.nll_loss", (((4, 5), "logunit"), ((4,), "int:5")), only=(0,))
_f("F.square_error_cost", ((S, "f"), (S, "f2")))
_f("F.log_loss", ((S, "unit"), (S, "unit")), only=(0,))
_f("F.margin_ranking_loss", ((V, "f"), (V, "f2"), (V, "sign")), only=(0, 1))
_f("F.cosine_embedding_loss", (((2, 4), "f"), ((2, 4), "f2"),
                               ((2,), "sign")), only=(0, 1))
_f("F.triplet_margin_loss", ((S, "f"), (S, "f2"), (S, "f3")))
_f("F.hinge_embedding_loss", ((S, "fnz"), (S, "sign")), only=(0,))
_f("F.sigmoid_focal_loss", ((S, "f"), (S, "unit")), only=(0,))
_f("F.softmax_with_cross_entropy", (((4, 5), "f"), ((4, 1), "int:5")),
   only=(0,))
_f("F.fused_linear_cross_entropy", (((6, 4), "f"), ((5, 4), "f"),
                                    ((6,), "int:5")), only=(0, 1))
_f("F.linear", (((3, 4), "f"), ((4, 5), "f"), ((5,), "f")))
_f("F.conv2d", (((1, 2, 5, 5), "f"), ((3, 2, 3, 3), "f")))
_f("F.conv1d", (((1, 2, 8), "f"), ((3, 2, 3), "f")))
_f("F.conv2d_transpose", (((1, 2, 4, 4), "f"), ((2, 3, 3, 3), "f")))
_f("F.avg_pool2d", (((1, 2, 4, 4), "f"),), kwargs=dict(kernel_size=2))
_f("F.max_pool2d", (((1, 2, 4, 4), "funique"),), kwargs=dict(kernel_size=2))
_f("F.adaptive_avg_pool2d", (((1, 2, 4, 4), "f"),),
   kwargs=dict(output_size=2))
_f("F.layer_norm_w", (((3, 4), "f"), ((4,), "fp"), ((4,), "f")))
_f("F.embedding", (((3,), "int:5"), ((5, 4), "f")), only=(1,))
_f("F.dropout_eval", ((S, "f"),))
_f("F.unfold", (((1, 2, 4, 4), "f"),), kwargs=dict(kernel_sizes=2))
_f("F.interpolate_nearest", (((1, 2, 4, 4), "f"),), only=(0,))
_f("F.pixel_shuffle", (((1, 4, 2, 2), "f"),), kwargs=dict(upscale_factor=2))
_f("F.grid_sample", (((1, 1, 4, 4), "f"), ((1, 2, 2, 2), "unit")))
_f("F.scaled_dot_product_attention",
   (((1, 4, 2, 4), "f"), ((1, 4, 2, 4), "f2"), ((1, 4, 2, 4), "f3")),
   kwargs=dict(training=False))
_f("F.group_norm", (((2, 4, 3, 3), "f"),), kwargs=dict(num_groups=2))
_f("F.instance_norm", (((2, 3, 4, 4), "f"),))
_f("F.batch_norm", (((2, 3, 4, 4), "f"), ((3,), "f2"), ((3,), "fp"),
                    ((3,), "fp"), ((3,), "f3")),
   kwargs=dict(training=False), only=(0, 3, 4))
_f("F.cosine_similarity", (((3, 4), "fnz"), ((3, 4), "f2")))
_f("F.fold", (((1, 8, 4), "f"),),
   kwargs=dict(output_sizes=[4, 4], kernel_sizes=2, strides=2))

#: the number of the JAX table's ``F.*`` entries above
N_JAX_F = len(F_OPS)

# -------------------------------------------- the port's own ``F.*`` entries --
# the registry ops the JAX table's entries miss
_f("F.tanh", ((S, "f"),))
_f("F.swish", ((S, "fnz"),))
_f("F.label_smooth", ((S, "unit"),), kwargs=dict(epsilon=0.2))
_f("F.label_smooth", ((S, "unit"), ((1, 4), "unit")),
   kwargs=dict(epsilon=0.2))
_f("F.bilinear", (((3, 4), "f"), ((3, 5), "f2"), ((2, 4, 5), "f3"),
                  ((2,), "f")))
_f("F.diag_embed", (((2, 3), "f"),), kwargs=dict(offset=1, dim1=0, dim2=2))
_f("F.nll_loss", (((4, 5), "logunit"), ((4,), "int:5"), ((5,), "unit")),
   kwargs=dict(ignore_index=1), only=(0,))
_f("F.binary_cross_entropy_with_logits", ((S, "f"), (S, "unit"),
                                          (S, "unit")), only=(0,))
_f("F.bce_logits_pos", ((S, "f"), (S, "unit"), ((4,), "fp")), only=(0,))
_f("F.bce_logits_weight_pos", ((S, "f"), (S, "unit"), (S, "unit"),
                               ((4,), "fp")), only=(0,))
_f("F.sigmoid_focal_loss", ((S, "f"), (S, "unit"), ((1,), "fp")),
   kwargs=dict(alpha=0.4, gamma=1.5), only=(0,))
_f("F.gumbel_softmax_noise", ((S, "f"), (S, "f2")), only=(0,))
_f("F.rrelu_slopes", ((S, "fnz"), (S, "unit")))
_f("F.dropout_masked", ((S, "f"), (S, "keep")))
_f("F.alpha_dropout_masked", ((S, "f"), (S, "keep")))
_f("F.triplet_margin_with_distance_loss", ((S, "f"), (S, "f2"), (S, "f3")))
_f("F.multi_label_soft_margin_loss", ((S, "f"), (S, "unit")), only=(0,))
_f("F.multi_label_soft_margin_loss", ((S, "f"), (S, "unit"), ((4,), "unit")),
   kwargs=dict(reduction="sum"), only=(0,))
_f("F.npair_loss", ((S, "f"), (S, "f2"), ((3,), "int:2")), only=(0, 1))
_f("F.dice_loss", ((S, "unit"), ((3, 1), "int:4")), only=(0,))
_f("F.zeropad2d", (((1, 2, 3, 3), "f"),), kwargs=dict(padding=[1, 0, 2, 1]))
_f("F.pixel_unshuffle", (((1, 2, 4, 4), "f"),),
   kwargs=dict(downscale_factor=2))
_f("F.channel_shuffle", (((1, 4, 2, 2), "f"),), kwargs=dict(groups=2))
_f("F.temporal_shift", (((4, 4, 2, 2), "f"),), kwargs=dict(seg_num=2))
_f("F.affine_grid", (((2, 2, 3), "f"),),
   kwargs=dict(out_shape=[2, 1, 3, 4], align_corners=False))
_f("F.local_response_norm", (((1, 5, 3, 3), "f"),), kwargs=dict(size=3))
_f("F.spectral_norm", (((4, 6), "f"), ((4,), "f2"), ((6,), "f3")),
   kwargs=dict(power_iters=2), only=(0,))
_f("F.adaptive_max_pool1d", (((1, 2, 7), "funique"),),
   kwargs=dict(output_size=3))
_f("F.adaptive_max_pool3d", (((1, 1, 4, 4, 4), "funique"),),
   kwargs=dict(output_size=2))
_f("F.ctc_loss_full", (((12, 2, 5), "f"), ((2, 3), "int:4")), only=(0,))
_f("F.conv1d_transpose", (((1, 2, 5), "f"), ((2, 3, 3), "f")),
   kwargs=dict(stride=2, padding=[1, 0], output_padding=1))
_f("F.conv2d_transpose", (((1, 4, 4, 4), "f"), ((4, 2, 3, 3), "f"),
                          ((4,), "f2")),
   kwargs=dict(stride=2, padding=1, groups=2, dilation=2))
_f("F.conv3d_transpose", (((1, 2, 3, 3, 3), "f"), ((2, 2, 2, 2, 2), "f")),
   kwargs=dict(stride=2, output_size=[7, 6, 6]))
_f("F.interpolate", (((1, 2, 5, 5), "f"),),
   kwargs=dict(size=[3, 3], mode="bilinear"))
_f("F.interpolate", (((1, 2, 5, 5), "f"),), kwargs=dict(size=[3, 2]),
   only=(0,))
_f("F.interpolate", (((1, 1, 3, 3), "f"),),
   kwargs=dict(scale_factor=2, mode="bicubic"))
_f("F.interpolate", (((1, 2, 4), "f"),), kwargs=dict(size=7, mode="linear"))
_f("F.interpolate", (((1, 1, 3, 3, 3), "f"),),
   kwargs=dict(size=[2, 4, 5], mode="trilinear"))
_f("F.unfold", (((1, 2, 4, 4), "f"),),
   kwargs=dict(kernel_sizes=2, paddings=[1, 0, 0, 1], dilations=[1, 2]))
_f("F.fold", (((1, 8, 6), "f"),),
   kwargs=dict(output_sizes=[4, 4], kernel_sizes=2, strides=2,
               paddings=[1, 0, 1, 0]))
_f("F.grid_sample", (((1, 2, 4, 4), "f"), ((1, 3, 2, 2), "f")),
   kwargs=dict(mode="nearest", align_corners=False), only=(0,))
_f("F.group_norm_affine", (((2, 4, 3, 3), "f"), ((4,), "fp"),
                           ((4,), "f2")))
_f("F.instance_norm", (((2, 3, 5), "f"),))
# options where PyTorch's function of the same name means something else,
# and the others' non-default options
_f("F.hardsigmoid", ((S, "wide"),), kwargs=dict(slope=0.2, offset=0.3))
_f("F.hardswish", ((S, "wide"),))
_f("F.relu6", ((S, "wide"),))
_f("F.hardtanh", ((S, "wide"),), kwargs=dict(min=-2.0, max=3.0))
_f("F.softplus", ((S, "f"),), kwargs=dict(beta=2.0, threshold=0.5))
_f("F.smooth_l1_loss", ((S, "f"), (S, "f2")),
   kwargs=dict(delta=0.25, reduction="sum"))
_f("F.smooth_l1_loss", ((S, "wide"), (S, "f2")))
_f("F.kl_div", ((S, "logunit"), (S, "unit")),
   kwargs=dict(reduction="batchmean"), only=(0,))
_f("F.kl_div", ((S, "logunit"), (S, "unit")), kwargs=dict(reduction="none"),
   only=(0,))
_f("F.dropout_infer", ((S, "f"),))
_f("F.rrelu", ((S, "fnz"),), kwargs=dict(lower=0.1, upper=0.3))
_f("F.thresholded_relu", ((S, "fnz"),), kwargs=dict(threshold=0.2,
                                                    value=-0.5))
_f("F.leaky_relu", ((S, "fnz"),), kwargs=dict(negative_slope=0.2))
_f("F.elu", ((S, "fnz"),), kwargs=dict(alpha=0.5))
_f("F.celu", ((S, "fnz"),), kwargs=dict(alpha=0.7))
_f("F.selu", ((S, "fnz"),), kwargs=dict(scale=1.2, alpha=1.5))
_f("F.gelu", ((S, "fnz"),), kwargs=dict(approximate=True))
_f("F.prelu", (((2, 3, 2, 2), "fnz"), ((3,), "unit")))
_f("F.prelu", (((2, 2, 2, 3), "fnz"), ((3,), "unit")),
   kwargs=dict(data_format="NHWC"))
_f("F.maxout", (((1, 2, 2, 4), "funique"),), kwargs=dict(groups=2, axis=3))
_f("F.glu", (((4, 3), "f"),), kwargs=dict(axis=0))
_f("F.log_softmax", ((S, "f"),), kwargs=dict(axis=0))
_f("F.normalize", ((S, "f"),), kwargs=dict(p=1, axis=-1))
_f("F.cosine_similarity", (((3, 4), "fnz"), ((3, 4), "f2")),
   kwargs=dict(axis=0))
_f("F.triplet_margin_loss", ((S, "f"), (S, "f2"), (S, "f3")),
   kwargs=dict(p=1.0, swap=True))
_f("F.margin_ranking_loss", ((V, "f"), (V, "f2"), (V, "sign")),
   kwargs=dict(margin=0.2, reduction="sum"), only=(0, 1))
_f("F.hinge_embedding_loss", ((S, "fnz"), (S, "sign")),
   kwargs=dict(margin=0.5), only=(0,))
_f("F.cosine_embedding_loss", (((2, 4), "f"), ((2, 4), "f2"),
                               ((2,), "sign")), kwargs=dict(margin=0.2),
   only=(0, 1))

# ------------------------------------------------------- non-differentiable --


def _nd(api, inputs, kwargs=None):
    _op(api, inputs, kwargs, only=(), table=NONDIFF)


for name in ["isnan", "isinf", "isfinite", "logical_not", "argsort"]:
    _nd(f"ops.{name}", ((S, "f"),))
for name in ["equal", "not_equal", "greater_than", "greater_equal",
             "less_than", "less_equal", "isclose", "equal_all", "allclose"]:
    _nd(f"ops.{name}", ((S, "f"), (S, "f2")))
for name in ["logical_and", "logical_or", "logical_xor"]:
    _nd(f"ops.{name}", ((S, "bool"), (S, "bool")))
for name in ["bitwise_and", "bitwise_or", "bitwise_xor"]:
    _nd(f"ops.{name}", ((S, "int:16"), (S, "int:16")))
_nd("ops.bitwise_not", ((S, "int:16"),))
_nd("ops.argmax", ((S, "funique"),), dict(axis=1))
_nd("ops.argmin", ((S, "funique"),))
_nd("ops.all", ((S, "bool"),), dict(axis=0))
_nd("ops.any", ((S, "bool"),))
_nd("ops.count_nonzero", ((S, "bool"),), dict(axis=1))
_nd("ops.nonzero", ((S, "bool"),))
_nd("ops.searchsorted", ((V, "sorted"), ((5,), "f")))
_nd("ops.bucketize", (((5,), "f"), (V, "sorted")))
_nd("ops.kthvalue", ((S, "funique"),), dict(k=2))
_nd("ops.mode", ((S, "int:3"),))
_nd("ops.unique", ((V, "int:4"),))
_nd("ops.unique_consecutive", ((V, "int:2"),))
_nd("ops.bincount", ((V, "int:5"),))
_nd("ops.matrix_rank", ((M33, "spd"),))
_nd("ops.numel", ((S, "f"),))
_nd("ops.shape", ((S, "f"),))
_nd("ops.rank", ((S, "f"),))
_nd("ops.is_empty", ((S, "f"),))
_nd("ops.zeros", (), dict(shape=[3, 4]))
_nd("ops.ones", (), dict(shape=[3, 4], dtype="int64"))
_nd("ops.full", (), dict(shape=[3, 4], fill_value=1.5))
_nd("ops.arange", (), dict(start=0, end=12, step=2))
_nd("ops.linspace", (), dict(start=0.0, stop=1.0, num=7))
_nd("ops.logspace", (), dict(start=0.0, stop=2.0, num=5))
_nd("ops.eye", (), dict(num_rows=3, num_columns=4))
_nd("ops.tril_indices", (), dict(row=4, col=4, offset=0))
_nd("ops.triu_indices", (), dict(row=4, col=4, offset=1))
_nd("ops.ones_like", ((S, "f"),))
_nd("ops.full_like", ((S, "f"),), dict(fill_value=2.0))
_nd("ops.meshgrid2", (((3,), "f"), ((4,), "f")))
_nd("F.one_hot", ((V, "int:4"),), dict(num_classes=4))

#: the JAX table's ops that get no low-precision run (fp32-only routines)
LOWP = {"ops.inverse", "ops.det", "ops.slogdet", "ops.cholesky",
        "ops.solve", "ops.triangular_solve", "ops.cholesky_solve",
        "ops.pinv", "ops.qr", "ops.eigh", "ops.matrix_power",
        # the port's linalg entries, for the same reason
        "ops.cond", "ops.lstsq", "ops.svdvals", "ops.eigvalsh",
        "ops.matrix_rank"}

#: the entries held to linalg's looser limits
LINALG = LOWP | {"ops.multi_dot", "ops.cov"}


def draw(shape, domain, rng):
    """An input of ``shape`` from ``domain``, as the JAX package's sweep
    draws it (``tests/test_op_grad_sweep.py``), plus ``sorted``."""
    if domain in ("f", "f2", "f3"):
        return rng.uniform(-0.9, 0.9, shape).astype(np.float32)
    if domain == "fp":
        return rng.uniform(0.2, 1.2, shape).astype(np.float32)
    if domain == "wide":
        # past the corners of relu6, hardswish and hardsigmoid
        return rng.uniform(-8.0, 8.0, shape).astype(np.float32)
    if domain == "keep":
        # a dropout keep-mask: 1.0 kept, 0.0 dropped
        return (rng.uniform(0, 1, shape) < 0.6).astype(np.float32)
    if domain == "fnz":
        return (rng.uniform(0.15, 0.9, shape)
                * rng.choice([-1.0, 1.0], shape)).astype(np.float32)
    n = int(np.prod(shape))
    if domain == "funique" and n > 1024:
        # distinct at any size: a permutation of integers times a power of
        # two (base + ramp collides in fp32 past a few thousand values)
        scale = 2.0 ** -int(np.ceil(np.log2(n)))
        return ((rng.permutation(n) - n // 2) * scale).reshape(
            shape).astype(np.float32)
    if domain == "funique":
        base = rng.uniform(-1, 1, shape)
        ramp = np.arange(n).reshape(shape) * 1e-2
        return (base + ramp).astype(np.float32)
    if domain == "funique_bf16":
        # distinct in bf16: at most 4096 values, 128 a binade over 16
        # binades and both signs
        m = np.arange(128) / 128.0 + 1.0
        pos = (m[None, :] * 2.0 ** (np.arange(16)[:, None] - 8)).ravel()
        pool = np.concatenate([pos, -pos])
        return rng.choice(pool, n, replace=False).reshape(shape).astype(
            np.float32)
    if domain == "sorted":
        return np.sort(rng.uniform(-1, 1, shape)).astype(np.float32)
    if domain == "unit":
        return rng.uniform(0.1, 0.9, shape).astype(np.float32)
    if domain == "logunit":
        return np.log(rng.uniform(0.1, 0.9, shape)).astype(np.float32)
    if domain == "gt1":
        return rng.uniform(1.2, 2.0, shape).astype(np.float32)
    if domain == "sign":
        return rng.choice([-1.0, 1.0], shape).astype(np.float32)
    if domain == "spd":
        # eigenvalues spaced evenly over [1, 2] in a random basis: well
        # conditioned at any size, a determinant fp32 holds at moderate
        # sizes, and eigenvectors (whose error grows as the gaps shrink)
        # defined to fp32's accuracy
        n = shape[-1]
        q, _ = np.linalg.qr(rng.uniform(-1, 1, (n, n)))
        lam = np.linspace(1.0, 2.0, n)
        return ((q * lam) @ q.T).astype(np.float32)
    if domain == "trilpd":
        n = shape[-1]
        a = np.tril(rng.uniform(0.2, 1.0, shape)) / n + np.eye(n)
        return a.astype(np.float32)
    if domain == "bool":
        return rng.uniform(0, 1, shape) > 0.5
    if domain.startswith("int:"):
        hi = int(domain.split(":")[1])
        return rng.randint(0, hi, shape).astype(np.int64)
    raise ValueError(domain)


def differentiable_inputs(entry):
    """Indices of an entry's inputs that get a gradient."""
    idx = [i for i, (_, d) in enumerate(entry["inputs"])
           if not (d in ("bool", "sign", "sorted", "keep")
                   or d.startswith("int:"))]
    if entry["only"] is not None:
        idx = [i for i in idx if i in entry["only"]]
    return idx


#: an input's largest number of elements in the card's sweep
SIZE_CAP = 1 << 22
#: ``k`` of the ops whose work grows faster than their inputs' size
K_OF = {"ops.kron": 16, "ops.bmm": 64, "ops.det": 16, "ops.flatten": 128,
        "ops.moveaxis": 128, "ops.cummax": 256, "ops.cummin": 256,
        "F.diag_embed": 16, "F.scaled_dot_product_attention": 16,
        "F.bilinear": 16, "F.conv3d_transpose": 8, "F.ctc_loss_full": 8,
        # the output size is an attribute: the inputs keep theirs
        "F.affine_grid": 1, "F.fold": 1}
#: ``k`` of the linalg entries (256-square matrices from 3-square ones)
K_LINALG = 85
_SHAPE_KW = {"shape", "repeat_times"}
#: axes that keep their size when an entry grows (``{input: axes}``): the
#: index tuple's length of gather_nd / scatter_nd_add, cross's axis of 3,
#: the two rows setitem_rows writes
_KEEP = {"ops.gather_nd": {1: (1,)}, "ops.scatter_nd_add": {1: (1,)},
         "ops.cross": {0: (0,), 1: (0,)}, "ops.setitem_rows": {1: (0,)},
         "F.grid_sample": {1: (3,)},
         # a transposed conv's kernel keeps its 3 or 2 taps an axis, as its
         # users' do (cuDNN's bf16 transposed conv at 24 x 24 taps stood 5 %
         # from the CPU's)
         "F.conv1d_transpose": {1: (2,)}, "F.conv2d_transpose": {1: (2, 3)},
         "F.conv3d_transpose": {1: (2, 3, 4)}}


def _grow(d, k):
    return d if d == 1 else d * k


def scaled(entry, k):
    """``entry`` with every axis longer than 1 (and the index domains, and
    shape attributes) ``k`` times longer, ``k`` capped so that no input
    holds more than :data:`SIZE_CAP` elements (``K_OF``/``K_LINALG``
    override it)."""
    api = entry["api"]
    if api in K_OF:
        k = min(k, K_OF[api])
    elif api in LINALG:
        k = min(k, K_LINALG)
    while k > 1 and any(np.prod([_grow(d, k) for d in s]) > SIZE_CAP
                        for s, _ in entry["inputs"]):
        k //= 2
    inputs = []
    keep = _KEEP.get(api, {})
    for n, (shape, dom) in enumerate(entry["inputs"]):
        if dom.startswith("int:") and api not in (
                "ops.shard_index", "ops.gcd", "ops.lcm", "ops.mode",
                "ops.unique", "ops.unique_consecutive", "ops.bincount",
                "ops.bitwise_and", "ops.bitwise_or", "ops.bitwise_xor",
                "ops.bitwise_not"):
            dom = f"int:{_grow(int(dom[4:]), k)}"
        inputs.append((tuple(d if a in keep.get(n, ()) else _grow(d, k)
                             for a, d in enumerate(shape)), dom))
    kwargs = dict(entry["kwargs"])
    for key in _SHAPE_KW & set(kwargs):
        if key == "shape" and api in ("ops.reshape", "ops.expand"):
            kwargs[key] = [_grow(d, k) for d in kwargs[key]]
    for key in ("row", "col", "num_rows", "num_columns", "end", "num"):
        if key in kwargs and api.startswith("ops."):
            kwargs[key] = _grow(kwargs[key], k)
    if api in ("ops.zeros", "ops.ones", "ops.full"):
        kwargs["shape"] = [_grow(d, k) for d in kwargs["shape"]]
    return dict(entry, inputs=tuple(inputs), kwargs=kwargs, k=k)


def resolve(api, paddle):
    """The callable of ``api`` in ``paddle`` (the port's top-level package;
    ``F.*`` in its ``nn.functional``). The adapters are the JAX sweep's
    pseudo-APIs, and the port's: a random functional's op given its mask or
    noise, an option the entry's keywords cannot reach."""
    F = paddle.nn.functional
    adapters = {
        "ops.concat2": lambda a, b, axis=0: paddle.concat([a, b], axis=axis),
        "ops.stack2": lambda a, b, axis=0: paddle.stack([a, b], axis=axis),
        "ops.split_first": lambda x, num_or_sections=2: paddle.split(
            x, num_or_sections)[0],
        "ops.where3": lambda c, a, b: paddle.where(c, a, b),
        "ops.einsum_ij_jk": lambda a, b: paddle.einsum("ij,jk->ik", a, b),
        "ops.multi_dot": lambda a, b: paddle.multi_dot([a, b]),
        "ops.pad2d": lambda x, pad=None: paddle.pad(x, pad),
        "ops.getitem_slice": lambda x: x[0:2, 1:3],
        "ops.multiplex2": lambda a, b: paddle.multiplex(
            [a, b], paddle.zeros([a.shape[0], 1], dtype="int32")),
        # an in-place op differentiates through a copy of its leaf input
        "ops.fill_diagonal_": lambda x, **kw: paddle.fill_diagonal_(
            x * 1.0, **kw),
        "ops.norm_fro": lambda x: paddle.norm(x, p="fro", axis=[0, 1]),
        "ops.as_real_complex": lambda x: paddle.as_real(paddle.as_complex(
            paddle.stack([x, x * 0.5], axis=-1))),
        "ops.index_put": lambda x, i, v: paddle.index_put(x, (i,), v),
        "ops.index_put_add": lambda x, i, v: paddle.index_put(
            x, (i,), v, accumulate=True),
        "ops.setitem_rows": _setitem_rows,
        "ops.cast_f64": lambda x: paddle.cast(x, "float64"),
        "ops.increment_copy": lambda x: paddle.increment(x * 1.0, 0.5),
        "ops.meshgrid2": lambda a, b: paddle.meshgrid(a, b),
        "ops.index_add": lambda x, i, v, axis=0: paddle.index_add(
            x, i, axis, v),
        "ops.svdvals": lambda x: paddle.svd(x)[1],
        "F.cross_entropy_labels": lambda x, y: F.cross_entropy(x, y),
        "F.layer_norm_w": lambda x, w, b: F.layer_norm(
            x, [int(x.shape[-1])], w, b),
        "F.dropout_eval": lambda x: F.dropout(x, 0.5, training=False),
        "F.interpolate_nearest": lambda x: F.interpolate(
            x, scale_factor=2, mode="nearest"),
        "F.group_norm_affine": lambda x, w, b: F.group_norm(
            x, 4, 1e-5, w, b),
        "F.ctc_loss_full": lambda x, y: F.ctc_loss(
            x, y + 1, paddle.full([x.shape[1]], x.shape[0], "int64"),
            paddle.full([y.shape[0]], y.shape[1], "int64")),
        "F.dropout_infer": lambda x: F.dropout(
            x, 0.3, training=False, mode="downscale_in_infer"),
        "F.bce_logits_pos": lambda x, y, pw:
            F.binary_cross_entropy_with_logits(x, y, pos_weight=pw),
        "F.bce_logits_weight_pos": lambda x, y, w, pw:
            F.binary_cross_entropy_with_logits(x, y, w, pos_weight=pw),
        "F.gumbel_softmax_noise": lambda x, g:
            F.activation._gumbel_softmax_raw(x, g, temperature=0.5),
        "F.rrelu_slopes": lambda x, a: F.activation._prelu_like(x, a),
        "F.dropout_masked": lambda x, m: F.common._dropout_masked(
            x, m, scale=2.5),
        "F.alpha_dropout_masked": lambda x, m:
            F.common._alpha_dropout_masked(x, m, alpha_p=-1.7581, a=0.8,
                                           b=0.3),
    }
    if api in adapters:
        return adapters[api]
    ns, name = api.split(".", 1)
    return getattr(F if ns == "F" else paddle, name)


@contextlib.contextmanager
def registry_ops_called():
    """A set that collects the name of every registry op run inside the
    block (every one goes through ``dispatch.apply_op``, which is wrapped
    for the block's length only)."""
    called = set()
    real = dispatch.apply_op

    def counting(name, *args, **kwargs):
        called.add(name)
        return real(name, *args, **kwargs)

    dispatch.apply_op = counting
    try:
        yield called
    finally:
        dispatch.apply_op = real


def _setitem_rows(x, v):
    y = x * 1.0
    y[1:3] = v
    return y


def run(entry, arrays, paddle, place, dtype=None, seed=0):
    """Run ``entry`` on ``arrays`` (from :func:`draw`) on ``place`` through
    the port's API: the forward outputs as numpy arrays and, when it has
    differentiable inputs, their gradients of ``sum(out * c)`` with ``out``
    the first output and ``c`` a cotangent from ``RandomState(seed)``.
    ``dtype`` casts the floating inputs (``"bfloat16"``)."""
    fn = resolve(entry["api"], paddle)
    diff = differentiable_inputs(entry)
    tensors = []
    for i, a in enumerate(arrays):
        t = paddle.to_tensor(a, place=place)
        if dtype is not None and a.dtype == np.float32:
            t = t.astype(dtype)
        if i in diff:
            t.stop_gradient = False
        tensors.append(t)
    out = fn(*tensors, **entry["kwargs"])
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    first = outs[0]
    grads = None
    if diff and not first.stop_gradient:
        c = np.random.RandomState(seed).uniform(-1, 1, first.shape)
        ct = paddle.to_tensor(c.astype(np.float32), place=place).astype(
            first.dtype)
        loss = paddle.sum(first * ct)
        grads = paddle.grad(loss, [tensors[i] for i in diff],
                            allow_unused=True)
        grads = [None if g is None else g.numpy() for g in grads]
    return [o.numpy() for o in outs], grads
