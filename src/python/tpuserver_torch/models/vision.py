"""The vision zoo, the port of ``tpuserver/models/vision.py``: ResNet-50
v1.5 and DenseNet-121 as ``TorchModel``s, the image preprocess model and
the image ensemble (BASELINE configs #2 and #3).

The wire input is NHWC float32 ``[B, 224, 224, 3]``, as in the JAX
package; the network reads it as NCHW in ``channels_last`` memory (a
permuted view, no copy), so cuDNN runs its NHWC kernels.  Weights are
OIHW in ``channels_last`` memory, bf16 by default.  The numerics follow
the JAX package's:

- a convolution accumulates in float32 and rounds to the activation
  dtype (``vision.py``'s ``_conv``);
- batch norm is folded to a per-channel multiply-add, then ReLU, in the
  activation dtype (``_scale_shift``);
- ``SAME`` padding is XLA's, which is asymmetric: the low pad is
  ``total // 2`` and the high pad the rest (the 7x7/2 stem pads 2 and 3
  at 224; a 3x3/2 convolution and the 3x3/2 max pool pad 0 and 1).
  torch's symmetric ``padding=`` would shift every window, so an
  asymmetric pad goes through ``F.pad`` (``-inf`` before the max pool,
  ``reduce_window``'s init);
- the global mean accumulates in float32 and rounds to the activation
  dtype; the classifier's softmax runs in float32 on the logits;
- DenseNet's growing concatenation keeps the channel order: the layer's
  input first, its new features after.

Weights are random: ``init_params(generator, device)`` draws them from a
seeded ``torch.Generator`` with the JAX package's distributions (He
normal convolutions, unit scale and zero shift, fc normal times 0.01,
zero bias), and ``params_from_jax(np_tree, device)`` carries the JAX
package's own draw across (HWIO -> OIHW; bf16 through its ``np.uint16``
bits).  ``logits(x)`` is the pre-softmax test hook.  No kernel of the
port lies on this path: the JAX package computes these convolutions,
pools and products in XLA, not Pallas, so the port calls
``torch.nn.functional``'s."""

import math
import threading

import numpy as np
import torch
import torch.nn.functional as F

from tpuserver_torch.core import Model, TensorSpec, TorchModel
from tpuserver_torch.models.tree import (  # noqa: F401 (re-exported)
    tree_cast,
    tree_from_jax,
    tree_map,
)

IMAGE_SIZE = 224
N_CLASSES = 1000


def _same_pads(size, k, stride):
    """XLA's ``SAME`` padding of one spatial dim: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, k, stride, value=0.0):
    """``x`` [B, C, H, W] and the symmetric padding left for the op:
    an asymmetric ``SAME`` pad is applied here, a symmetric one returned
    for the op to apply."""
    ph = _same_pads(x.shape[2], k, stride)
    pw = _same_pads(x.shape[3], k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return x, (ph[0], pw[0])
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)
    return x.contiguous(memory_format=torch.channels_last), (0, 0)


def conv(x, w, stride=1):
    """XLA's ``SAME`` convolution of ``x`` [B, C, H, W] with ``w`` [O, I,
    kh, kw] (kh == kw): float32 accumulation, the result in ``x``'s
    dtype."""
    x, padding = _pad_same(x, w.shape[2], stride)
    return F.conv2d(x, w, stride=stride, padding=padding)


def max_pool_same(x, k=3, stride=2):
    """``reduce_window(max, -inf)`` with ``SAME`` padding."""
    x, padding = _pad_same(x, k, stride, value=-math.inf)
    return F.max_pool2d(x, k, stride, padding=padding)


def scale_shift_relu(x, bn):
    """The folded batch norm ``x * scale + shift``, then ReLU."""
    return torch.relu_(torch.addcmul(bn["shift"], x, bn["scale"]))


def global_mean(x):
    """The mean over H and W, accumulated in float32."""
    return x.mean(dim=(2, 3), dtype=torch.float32).to(x.dtype)


def _conv_w(generator, device, kh, kw, cin, cout, dtype):
    fan_in = kh * kw * cin
    w = torch.randn((cout, cin, kh, kw), generator=generator,
                    device=device, dtype=torch.float32)
    return (w * math.sqrt(2.0 / fan_in)).to(dtype).contiguous(
        memory_format=torch.channels_last)


def _bn(device, c, dtype):
    return {"scale": torch.ones((c, 1, 1), dtype=dtype, device=device),
            "shift": torch.zeros((c, 1, 1), dtype=dtype, device=device)}


def _fc(generator, device, cin, dtype):
    w = torch.randn((cin, N_CLASSES), generator=generator, device=device,
                    dtype=torch.float32) * 0.01
    return {"w": w.to(dtype),
            "b": torch.zeros((N_CLASSES,), dtype=dtype, device=device)}


def _leaf_to_port(key, t, device):
    """One JAX leaf's layout in the port: HWIO -> OIHW (channels_last), a
    batch-norm vector -> [C, 1, 1]."""
    if t.ndim == 4:
        return t.permute(3, 2, 0, 1).to(device).contiguous(
            memory_format=torch.channels_last)
    if key in ("scale", "shift"):
        return t.reshape(-1, 1, 1).to(device)
    return t.to(device)


class _ImageNetModel(TorchModel):
    """Shared plumbing: NHWC [B, 224, 224, 3] float32 in, softmax
    probabilities [B, 1000] out, the dynamic batcher over power-of-two
    buckets up to 32, classification labels."""

    platform = "pytorch"
    backend = "pytorch"
    max_batch_size = 32
    dynamic_batching = True
    instance_count = 4
    inputs = (TensorSpec("INPUT", "FP32", [IMAGE_SIZE, IMAGE_SIZE, 3]),)
    outputs = (TensorSpec("OUTPUT", "FP32", [N_CLASSES]),)

    def __init__(self, device=None, seed=0, params=None,
                 dtype=torch.bfloat16):
        """``params``: the port's tree (``init_params`` or
        ``params_from_jax``) to serve, moved to ``device``; None draws
        one from ``seed`` at first use.  ``dtype`` is the activations'."""
        super().__init__(device)
        self.dtype = dtype
        self._seed = seed
        self._params = None if params is None else tree_map(
            lambda t: t.to(self.device), params)
        self._params_lock = threading.Lock()
        self.labels = {"OUTPUT": ["class_{}".format(i)
                                  for i in range(N_CLASSES)]}

    @classmethod
    def params_from_jax(cls, np_tree, device):
        """The JAX package's parameter tree (``_init_params()`` with
        ``jax.tree_util.tree_map(np.asarray, ...)``) as the port's."""
        return tree_from_jax(np_tree, device, _leaf_to_port)

    def params(self):
        if self._params is None:
            with self._params_lock:
                if self._params is None:
                    gen = torch.Generator(device=self.device)
                    gen.manual_seed(self._seed)
                    self._params = self.init_params(gen, self.device,
                                                    self.dtype)
        return self._params

    def logits(self, images, params=None):
        """The pre-softmax logits of NHWC ``images`` (a tensor on the
        model's device), in the activation dtype of ``params`` (default:
        the served weights)."""
        params = self.params() if params is None else params
        dtype = params["fc"]["w"].dtype
        x = images.to(dtype).permute(0, 3, 1, 2)  # channels_last view
        return self.apply(params, x)

    def forward(self, INPUT):
        return {"OUTPUT": torch.softmax(self.logits(INPUT).float(), dim=-1)}

    def buckets(self):
        """Every batch size the batcher runs (its power-of-two default up
        to ``max_batch_size``)."""
        sizes, b = [], 1
        while b < self.max_batch_size:
            sizes.append(b)
            b <<= 1
        return sizes + [self.max_batch_size]

    def warmup(self):
        """Run every bucket once on the calling thread, so none of its
        requests pays a first call (cuDNN builds an execution plan per
        shape and thread; its autotuner stays off, so every thread picks
        the same algorithms)."""
        for b in self.buckets():
            self.execute({"INPUT": np.zeros(
                [b] + list(self.inputs[0].shape), np.float32)}, None)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def operations(self, batch, size=IMAGE_SIZE):
        """The forward's convolution and fc FLOPs at ``batch``:
        2 * H_out * W_out * k^2 * C_in * C_out per convolution and 2 *
        C_in * 1000 per row for the fc, counted by walking the weights
        through the forward on meta tensors."""
        total = [0]

        def counting_conv(x, w, stride=1):
            y = conv(x, w, stride)
            o, i, kh, kw = w.shape
            total[0] += 2 * y.shape[0] * y.shape[2] * y.shape[3] * (
                kh * kw * i * o)
            return y

        meta = tree_map(lambda t: torch.empty_like(t, device="meta"),
                        self.params())
        x = torch.empty((batch, 3, size, size), device="meta",
                        dtype=self.dtype).contiguous(
            memory_format=torch.channels_last)
        self.apply(meta, x, conv=counting_conv)
        return total[0] + 2 * batch * meta["fc"]["w"].shape[0] * N_CLASSES


class ResNet50Model(_ImageNetModel):
    """ResNet-50 v1.5: stride 2 in the 3x3 convolution of a downsampling
    bottleneck; stages of (3, 4, 6, 3) bottlenecks."""

    name = "resnet50"
    _STAGES = (3, 4, 6, 3)
    _WIDTHS = (256, 512, 1024, 2048)

    @classmethod
    def init_params(cls, generator, device, dtype=torch.bfloat16):
        params = {"stem": {"w": _conv_w(generator, device, 7, 7, 3, 64,
                                        dtype),
                           "bn": _bn(device, 64, dtype)},
                  "stages": []}
        cin = 64
        for blocks, width in zip(cls._STAGES, cls._WIDTHS):
            mid = width // 4
            stage = []
            for b in range(blocks):
                blk = {"w1": _conv_w(generator, device, 1, 1, cin, mid,
                                     dtype),
                       "bn1": _bn(device, mid, dtype),
                       "w2": _conv_w(generator, device, 3, 3, mid, mid,
                                     dtype),
                       "bn2": _bn(device, mid, dtype),
                       "w3": _conv_w(generator, device, 1, 1, mid, width,
                                     dtype),
                       "bn3": _bn(device, width, dtype)}
                if b == 0:
                    blk["proj"] = _conv_w(generator, device, 1, 1, cin,
                                          width, dtype)
                    blk["proj_bn"] = _bn(device, width, dtype)
                stage.append(blk)
                cin = width
            params["stages"].append(stage)
        params["fc"] = _fc(generator, device, cin, dtype)
        return params

    @staticmethod
    def apply(params, x, conv=conv):
        """Logits of ``x`` [B, 3, H, W] (channels_last)."""
        x = scale_shift_relu(conv(x, params["stem"]["w"], 2),
                             params["stem"]["bn"])
        x = max_pool_same(x)
        for s, stage in enumerate(params["stages"]):
            for b, blk in enumerate(stage):
                stride = 2 if (b == 0 and s > 0) else 1
                shortcut = x
                if "proj" in blk:
                    shortcut = torch.addcmul(
                        blk["proj_bn"]["shift"],
                        conv(x, blk["proj"], stride),
                        blk["proj_bn"]["scale"])
                y = scale_shift_relu(conv(x, blk["w1"]), blk["bn1"])
                y = scale_shift_relu(conv(y, blk["w2"], stride), blk["bn2"])
                y = torch.addcmul(blk["bn3"]["shift"], conv(y, blk["w3"]),
                                  blk["bn3"]["scale"])
                x = torch.relu_(y + shortcut)
        return global_mean(x) @ params["fc"]["w"] + params["fc"]["b"]


class DenseNet121Model(_ImageNetModel):
    """DenseNet-121: dense blocks of (6, 12, 24, 16) layers, growth 32,
    transitions that halve the channels and average-pool 2x2."""

    name = "densenet121"
    _BLOCKS = (6, 12, 24, 16)
    _GROWTH = 32

    @classmethod
    def init_params(cls, generator, device, dtype=torch.bfloat16):
        growth = cls._GROWTH
        params = {"stem": {"w": _conv_w(generator, device, 7, 7, 3, 64,
                                        dtype),
                           "bn": _bn(device, 64, dtype)},
                  "blocks": [], "transitions": []}
        c = 64
        for i, layers in enumerate(cls._BLOCKS):
            block = []
            for _ in range(layers):
                block.append({
                    "bn1": _bn(device, c, dtype),
                    "w1": _conv_w(generator, device, 1, 1, c, 4 * growth,
                                  dtype),
                    "bn2": _bn(device, 4 * growth, dtype),
                    "w2": _conv_w(generator, device, 3, 3, 4 * growth,
                                  growth, dtype)})
                c += growth
            params["blocks"].append(block)
            if i < len(cls._BLOCKS) - 1:
                params["transitions"].append({
                    "bn": _bn(device, c, dtype),
                    "w": _conv_w(generator, device, 1, 1, c, c // 2, dtype)})
                c //= 2
        params["final_bn"] = _bn(device, c, dtype)
        params["fc"] = _fc(generator, device, c, dtype)
        return params

    @staticmethod
    def apply(params, x, conv=conv):
        """Logits of ``x`` [B, 3, H, W] (channels_last)."""
        x = scale_shift_relu(conv(x, params["stem"]["w"], 2),
                             params["stem"]["bn"])
        x = max_pool_same(x)
        for i, block in enumerate(params["blocks"]):
            for layer in block:
                y = conv(scale_shift_relu(x, layer["bn1"]), layer["w1"])
                y = conv(scale_shift_relu(y, layer["bn2"]), layer["w2"])
                x = torch.cat([x, y], dim=1)
            if i < len(params["transitions"]):
                tr = params["transitions"][i]
                x = conv(scale_shift_relu(x, tr["bn"]), tr["w"])
                x = F.avg_pool2d(x, 2, 2)
        x = scale_shift_relu(x, params["final_bn"])
        return global_mean(x) @ params["fc"]["w"] + params["fc"]["b"]


class ImagePreprocessModel(TorchModel):
    """Raw UINT8 pixels -> float32 network input (``/ 255``), the first
    step of the image ensemble; on the device, so the ensemble's tensors
    stay there."""

    name = "image_preprocess"
    platform = "pytorch"
    backend = "pytorch"
    max_batch_size = 32
    inputs = (TensorSpec("RAW_IMAGE", "UINT8", [IMAGE_SIZE, IMAGE_SIZE, 3]),)
    outputs = (TensorSpec("PREPROCESSED", "FP32",
                          [IMAGE_SIZE, IMAGE_SIZE, 3]),)

    def __init__(self, device=None):
        super().__init__(device)
        # a tensor divisor: a true division, where a Python scalar would
        # have the card multiply by its reciprocal (another rounding than
        # the host's x / 255)
        self._scale = torch.full((), 255.0, device=self.device)

    def forward(self, RAW_IMAGE):
        return {"PREPROCESSED": RAW_IMAGE.to(torch.float32) / self._scale}


class ImageEnsembleModel(Model):
    """RAW_IMAGE -> class probabilities through the preprocess model and
    ResNet-50 (``ensemble_scheduling``; the core runs the steps)."""

    name = "image_ensemble"
    platform = "ensemble"
    backend = ""
    max_batch_size = 32
    inputs = (TensorSpec("RAW_IMAGE", "UINT8", [IMAGE_SIZE, IMAGE_SIZE, 3]),)
    outputs = (TensorSpec("OUTPUT", "FP32", [N_CLASSES]),)
    ensemble_steps = [
        {"model_name": "image_preprocess", "model_version": -1,
         "input_map": {"RAW_IMAGE": "RAW_IMAGE"},
         "output_map": {"PREPROCESSED": "pixels"}},
        {"model_name": "resnet50", "model_version": -1,
         "input_map": {"INPUT": "pixels"},
         "output_map": {"OUTPUT": "OUTPUT"}},
    ]

    def __init__(self):
        self.labels = {"OUTPUT": ["class_{}".format(i)
                                  for i in range(N_CLASSES)]}


def vision_models(device=None, seed=0):
    """ResNet-50, DenseNet-121, the preprocess model and the image
    ensemble on ``device``, weights drawn from ``seed``."""
    return [ResNet50Model(device=device, seed=seed),
            DenseNet121Model(device=device, seed=seed),
            ImagePreprocessModel(device=device), ImageEnsembleModel()]
