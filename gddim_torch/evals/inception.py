"""InceptionV3 for FID and IS (counterpart of ``gddim_tpu/evals/inception.py``).

An ``nn.Module`` over a torchvision-layout state dict loaded from a local
``.npz`` (``eval.inception_weights``; no weights are in the repo and nothing
downloads). Each conv's BatchNorm is folded into a per-channel scale and
shift applied after the conv, as the JAX version does. Two variants, told
apart by the classifier's width:

- ``fid2015`` (1008 classes): the tfgan / 2015 frozen FID graph the
  reference scores with: input (x - 127.5) / 127.5, TF1's asymmetric
  bilinear resize to 299 (source i * in / out, no half-pixel offset), branch
  average pools that exclude the padding, a max-pool branch in Mixed_7c;
- ``torchvision`` (1000 classes): IMAGENET1K_V1, half-pixel bilinear resize
  of x / 255 to 299, then (x - 0.5) / 0.5, inclusive average pools.

Outputs ``pool_3`` (the 2048-d global average pool) and ``logits``. The convs
are ``F.conv2d``: the JAX version runs plain XLA convs there, not a kernel.
Activations are NCHW inside the module; it takes NHWC images in [0, 255].
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3  # torchvision BasicConv2d's BatchNorm eps


def fold_bn(sd: dict, prefix: str):
    """(OIHW kernel, scale, shift) float32 arrays of one conv + BatchNorm."""
    w = np.asarray(sd[f"{prefix}.conv.weight"], np.float32)
    gamma = np.asarray(sd[f"{prefix}.bn.weight"], np.float32)
    beta = np.asarray(sd[f"{prefix}.bn.bias"], np.float32)
    mean = np.asarray(sd[f"{prefix}.bn.running_mean"], np.float32)
    var = np.asarray(sd[f"{prefix}.bn.running_var"], np.float32)
    scale = gamma / np.sqrt(var + BN_EPS)
    return w, scale, beta - mean * scale


class ConvBN(nn.Module):
    """conv -> * scale + shift -> ReLU, the folded BasicConv2d."""

    def __init__(self, sd: dict, prefix: str, stride: int = 1, padding=0):
        super().__init__()
        w, scale, shift = fold_bn(sd, prefix)
        self.register_buffer("weight", torch.from_numpy(w.copy()))
        self.register_buffer("scale", torch.from_numpy(scale.copy())[:, None, None])
        self.register_buffer("shift", torch.from_numpy(shift.copy())[:, None, None])
        self.stride = stride
        self.padding = (padding, padding) if isinstance(padding, int) else tuple(padding)

    def forward(self, x):
        y = F.conv2d(x, self.weight, stride=self.stride, padding=self.padding)
        return F.relu(y * self.scale + self.shift)


def avgpool3(x, exclusive: bool):
    """3x3 stride-1 average pool over a 1-pixel zero pad; ``exclusive``
    divides by the taps inside the image (fid2015), else by 9."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=not exclusive)


def maxpool3s1(x):
    return F.max_pool2d(x, 3, stride=1, padding=1)


def maxpool3s2(x):
    return F.max_pool2d(x, 3, stride=2)


def _tf1_axis(n_in: int, n_out: int, device):
    src = np.arange(n_out, dtype=np.float64) * (n_in / n_out)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    frac = (src - i0).astype(np.float32)
    return (torch.from_numpy(i0).to(device), torch.from_numpy(i1).to(device),
            torch.from_numpy(frac).to(device))


def tf1_resize_bilinear(x, size: int):
    """TF1 ResizeBilinear (align_corners=False) of NHWC ``x`` to size x size."""
    _, h, w, _ = x.shape
    r0, r1, rf = _tf1_axis(h, size, x.device)
    c0, c1, cf = _tf1_axis(w, size, x.device)
    top, bot = x[:, r0], x[:, r1]
    rows = top + rf[None, :, None, None] * (bot - top)
    left, right = rows[:, :, c0], rows[:, :, c1]
    return left + cf[None, None, :, None] * (right - left)


class InceptionV3(nn.Module):
    def __init__(self, state_dict: dict, mode: str = "torchvision"):
        super().__init__()
        if mode not in ("torchvision", "fid2015"):
            raise ValueError(f"InceptionV3 mode {mode!r}")
        self.mode = mode
        self.exclusive = mode == "fid2015"
        self.convs = nn.ModuleDict()
        self._sd = state_dict
        self._stem()
        for n in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            self._inception_a(n)
        self._inception_b("Mixed_6a")
        for n in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            self._inception_c(n)
        self._inception_d("Mixed_7a")
        self._inception_e("Mixed_7b")
        self._inception_e("Mixed_7c")
        self.register_buffer("fc_weight", torch.from_numpy(
            np.asarray(state_dict["fc.weight"], np.float32).copy()))
        self.register_buffer("fc_bias", torch.from_numpy(
            np.asarray(state_dict["fc.bias"], np.float32).copy()))
        del self._sd

    @property
    def device(self):
        return self.fc_weight.device

    def _add(self, prefix, stride=1, padding=0):
        self.convs[prefix.replace(".", "__")] = ConvBN(self._sd, prefix, stride, padding)

    def _c(self, prefix, x):
        return self.convs[prefix.replace(".", "__")](x)

    # --- construction: each conv with its stride and padding ----------------
    def _stem(self):
        self._add("Conv2d_1a_3x3", stride=2)
        self._add("Conv2d_2a_3x3")
        self._add("Conv2d_2b_3x3", padding=1)
        self._add("Conv2d_3b_1x1")
        self._add("Conv2d_4a_3x3")

    def _inception_a(self, n):
        self._add(f"{n}.branch1x1")
        self._add(f"{n}.branch5x5_1")
        self._add(f"{n}.branch5x5_2", padding=2)
        self._add(f"{n}.branch3x3dbl_1")
        self._add(f"{n}.branch3x3dbl_2", padding=1)
        self._add(f"{n}.branch3x3dbl_3", padding=1)
        self._add(f"{n}.branch_pool")

    def _inception_b(self, n):
        self._add(f"{n}.branch3x3", stride=2)
        self._add(f"{n}.branch3x3dbl_1")
        self._add(f"{n}.branch3x3dbl_2", padding=1)
        self._add(f"{n}.branch3x3dbl_3", stride=2)

    def _inception_c(self, n):
        self._add(f"{n}.branch1x1")
        self._add(f"{n}.branch7x7_1")
        self._add(f"{n}.branch7x7_2", padding=(0, 3))
        self._add(f"{n}.branch7x7_3", padding=(3, 0))
        self._add(f"{n}.branch7x7dbl_1")
        self._add(f"{n}.branch7x7dbl_2", padding=(3, 0))
        self._add(f"{n}.branch7x7dbl_3", padding=(0, 3))
        self._add(f"{n}.branch7x7dbl_4", padding=(3, 0))
        self._add(f"{n}.branch7x7dbl_5", padding=(0, 3))
        self._add(f"{n}.branch_pool")

    def _inception_d(self, n):
        self._add(f"{n}.branch3x3_1")
        self._add(f"{n}.branch3x3_2", stride=2)
        self._add(f"{n}.branch7x7x3_1")
        self._add(f"{n}.branch7x7x3_2", padding=(0, 3))
        self._add(f"{n}.branch7x7x3_3", padding=(3, 0))
        self._add(f"{n}.branch7x7x3_4", stride=2)

    def _inception_e(self, n):
        self._add(f"{n}.branch1x1")
        self._add(f"{n}.branch3x3_1")
        self._add(f"{n}.branch3x3_2a", padding=(0, 1))
        self._add(f"{n}.branch3x3_2b", padding=(1, 0))
        self._add(f"{n}.branch3x3dbl_1")
        self._add(f"{n}.branch3x3dbl_2", padding=1)
        self._add(f"{n}.branch3x3dbl_3a", padding=(0, 1))
        self._add(f"{n}.branch3x3dbl_3b", padding=(1, 0))
        self._add(f"{n}.branch_pool")

    # --- forward ---------------------------------------------------------------
    def _a(self, x, n):
        b1 = self._c(f"{n}.branch1x1", x)
        b5 = self._c(f"{n}.branch5x5_2", self._c(f"{n}.branch5x5_1", x))
        b3 = self._c(f"{n}.branch3x3dbl_1", x)
        b3 = self._c(f"{n}.branch3x3dbl_3", self._c(f"{n}.branch3x3dbl_2", b3))
        bp = self._c(f"{n}.branch_pool", avgpool3(x, self.exclusive))
        return torch.cat([b1, b5, b3, bp], 1)

    def _b(self, x, n):
        b3 = self._c(f"{n}.branch3x3", x)
        bd = self._c(f"{n}.branch3x3dbl_1", x)
        bd = self._c(f"{n}.branch3x3dbl_3", self._c(f"{n}.branch3x3dbl_2", bd))
        return torch.cat([b3, bd, maxpool3s2(x)], 1)

    def _cc(self, x, n):
        b1 = self._c(f"{n}.branch1x1", x)
        b7 = self._c(f"{n}.branch7x7_1", x)
        b7 = self._c(f"{n}.branch7x7_3", self._c(f"{n}.branch7x7_2", b7))
        bd = self._c(f"{n}.branch7x7dbl_1", x)
        for i in range(2, 6):
            bd = self._c(f"{n}.branch7x7dbl_{i}", bd)
        bp = self._c(f"{n}.branch_pool", avgpool3(x, self.exclusive))
        return torch.cat([b1, b7, bd, bp], 1)

    def _d(self, x, n):
        b3 = self._c(f"{n}.branch3x3_2", self._c(f"{n}.branch3x3_1", x))
        b7 = self._c(f"{n}.branch7x7x3_1", x)
        for i in range(2, 5):
            b7 = self._c(f"{n}.branch7x7x3_{i}", b7)
        return torch.cat([b3, b7, maxpool3s2(x)], 1)

    def _e(self, x, n, max_pool: bool):
        b1 = self._c(f"{n}.branch1x1", x)
        b3 = self._c(f"{n}.branch3x3_1", x)
        b3 = torch.cat([self._c(f"{n}.branch3x3_2a", b3), self._c(f"{n}.branch3x3_2b", b3)], 1)
        bd = self._c(f"{n}.branch3x3dbl_2", self._c(f"{n}.branch3x3dbl_1", x))
        bd = torch.cat([self._c(f"{n}.branch3x3dbl_3a", bd),
                        self._c(f"{n}.branch3x3dbl_3b", bd)], 1)
        bp = maxpool3s1(x) if max_pool else avgpool3(x, self.exclusive)
        return torch.cat([b1, b3, bd, self._c(f"{n}.branch_pool", bp)], 1)

    def forward(self, images) -> dict:
        """images: (B, H, W, 3) uint8 or float in [0, 255]."""
        x = images.to(self.fc_weight.device, torch.float32)
        if self.mode == "fid2015":
            x = tf1_resize_bilinear((x - 127.5) / 127.5, 299).permute(0, 3, 1, 2)
        else:
            x = F.interpolate(x.permute(0, 3, 1, 2) / 255.0, size=(299, 299), mode="bilinear",
                              align_corners=False, antialias=False)
            x = (x - 0.5) / 0.5
        for name in ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3"):
            x = self._c(name, x)
        x = maxpool3s2(x)
        x = self._c("Conv2d_4a_3x3", self._c("Conv2d_3b_1x1", x))
        x = maxpool3s2(x)
        for n in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            x = self._a(x, n)
        x = self._b(x, "Mixed_6a")
        for n in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = self._cc(x, n)
        x = self._d(x, "Mixed_7a")
        x = self._e(x, "Mixed_7b", max_pool=False)
        x = self._e(x, "Mixed_7c", max_pool=self.mode == "fid2015")
        pool = x.mean(dim=(2, 3))
        return {"pool_3": pool, "logits": pool @ self.fc_weight.T + self.fc_bias}


def load_inception_extractor(weights_path: str, device="cuda"):
    """The FID feature extractor from a local weights .npz: 1008 classes is
    the fid2015 graph (the reference's numbers), 1000 torchvision's."""
    from gddim_torch.evals.features import FeatureExtractor

    path = Path(weights_path)
    if not path.exists():
        raise FileNotFoundError(
            f"inception weights not found at {weights_path}; export them from torchvision or "
            "pytorch-fid as a .npz of the state dict (gddim_tpu/evals/inception.py says how)")
    with np.load(path) as z:
        sd = {k: z[k] for k in z.files}
    n_classes = int(np.asarray(sd["fc.weight"]).shape[0])
    mode = "fid2015" if n_classes == 1008 else "torchvision"
    net = InceptionV3(sd, mode=mode).to(device).eval()
    name = "inception_fid2015" if mode == "fid2015" else "inception_v3"
    return FeatureExtractor(name, net, 2048, n_classes)


def random_state_dict(rng: np.random.Generator | None = None, n_classes: int = 1000) -> dict:
    """A random state dict of torchvision's InceptionV3 shapes (for tests and
    the card's smoke run): conv weights 0.05 N, BatchNorm at identity, fc
    0.02 N; the JAX package's generator, draw for draw."""
    rng = rng or np.random.default_rng(0)
    sd = {}

    def conv(prefix, cin, cout, kh, kw):
        sd[f"{prefix}.conv.weight"] = rng.normal(size=(cout, cin, kh, kw)).astype(np.float32) * 0.05
        for name, val in [("bn.weight", np.ones(cout)), ("bn.bias", np.zeros(cout)),
                          ("bn.running_mean", np.zeros(cout)), ("bn.running_var", np.ones(cout))]:
            sd[f"{prefix}.{name}"] = val.astype(np.float32)

    conv("Conv2d_1a_3x3", 3, 32, 3, 3)
    conv("Conv2d_2a_3x3", 32, 32, 3, 3)
    conv("Conv2d_2b_3x3", 32, 64, 3, 3)
    conv("Conv2d_3b_1x1", 64, 80, 1, 1)
    conv("Conv2d_4a_3x3", 80, 192, 3, 3)

    def inception_a(name, cin, pool_features):
        conv(f"{name}.branch1x1", cin, 64, 1, 1)
        conv(f"{name}.branch5x5_1", cin, 48, 1, 1)
        conv(f"{name}.branch5x5_2", 48, 64, 5, 5)
        conv(f"{name}.branch3x3dbl_1", cin, 64, 1, 1)
        conv(f"{name}.branch3x3dbl_2", 64, 96, 3, 3)
        conv(f"{name}.branch3x3dbl_3", 96, 96, 3, 3)
        conv(f"{name}.branch_pool", cin, pool_features, 1, 1)
        return 64 + 64 + 96 + pool_features

    def inception_b(name, cin):
        conv(f"{name}.branch3x3", cin, 384, 3, 3)
        conv(f"{name}.branch3x3dbl_1", cin, 64, 1, 1)
        conv(f"{name}.branch3x3dbl_2", 64, 96, 3, 3)
        conv(f"{name}.branch3x3dbl_3", 96, 96, 3, 3)
        return 384 + 96 + cin

    def inception_c(name, cin, c7):
        conv(f"{name}.branch1x1", cin, 192, 1, 1)
        conv(f"{name}.branch7x7_1", cin, c7, 1, 1)
        conv(f"{name}.branch7x7_2", c7, c7, 1, 7)
        conv(f"{name}.branch7x7_3", c7, 192, 7, 1)
        conv(f"{name}.branch7x7dbl_1", cin, c7, 1, 1)
        conv(f"{name}.branch7x7dbl_2", c7, c7, 7, 1)
        conv(f"{name}.branch7x7dbl_3", c7, c7, 1, 7)
        conv(f"{name}.branch7x7dbl_4", c7, c7, 7, 1)
        conv(f"{name}.branch7x7dbl_5", c7, 192, 1, 7)
        conv(f"{name}.branch_pool", cin, 192, 1, 1)
        return 192 * 4

    def inception_d(name, cin):
        conv(f"{name}.branch3x3_1", cin, 192, 1, 1)
        conv(f"{name}.branch3x3_2", 192, 320, 3, 3)
        conv(f"{name}.branch7x7x3_1", cin, 192, 1, 1)
        conv(f"{name}.branch7x7x3_2", 192, 192, 1, 7)
        conv(f"{name}.branch7x7x3_3", 192, 192, 7, 1)
        conv(f"{name}.branch7x7x3_4", 192, 192, 3, 3)
        return 320 + 192 + cin

    def inception_e(name, cin):
        conv(f"{name}.branch1x1", cin, 320, 1, 1)
        conv(f"{name}.branch3x3_1", cin, 384, 1, 1)
        conv(f"{name}.branch3x3_2a", 384, 384, 1, 3)
        conv(f"{name}.branch3x3_2b", 384, 384, 3, 1)
        conv(f"{name}.branch3x3dbl_1", cin, 448, 1, 1)
        conv(f"{name}.branch3x3dbl_2", 448, 384, 3, 3)
        conv(f"{name}.branch3x3dbl_3a", 384, 384, 1, 3)
        conv(f"{name}.branch3x3dbl_3b", 384, 384, 3, 1)
        conv(f"{name}.branch_pool", cin, 192, 1, 1)
        return 320 + 768 + 768 + 192

    c = 192
    c = inception_a("Mixed_5b", c, 32)
    c = inception_a("Mixed_5c", c, 64)
    c = inception_a("Mixed_5d", c, 64)
    c = inception_b("Mixed_6a", c)
    for n, c7 in [("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160), ("Mixed_6e", 192)]:
        c = inception_c(n, c, c7)
    c = inception_d("Mixed_7a", c)
    c = inception_e("Mixed_7b", c)
    c = inception_e("Mixed_7c", c)
    if c != 2048:
        raise AssertionError(c)
    sd["fc.weight"] = rng.normal(size=(n_classes, 2048)).astype(np.float32) * 0.02
    sd["fc.bias"] = np.zeros(n_classes, dtype=np.float32)
    return sd
