"""CNN model zoo: AlexNet, ResNet, ResNeXt-50, InceptionV3.

Counterpart of ``flexflow_tpu/models/cnn.py``, the same graphs and layer
names.  Reference apps:
  * AlexNet     — ``examples/cpp/AlexNet/alexnet.cc:70-83``
  * ResNet      — ``examples/cpp/ResNet/resnet.cc:36-112`` (bottleneck)
  * ResNeXt-50  — ``examples/cpp/resnext50/resnext.cc:14-86`` (grouped conv)
  * InceptionV3 — ``examples/cpp/InceptionV3/inception.cc:26-142``

All take NCHW inputs like the reference and return post-softmax class
probabilities.
"""

from __future__ import annotations

from flexflow_tpu_torch.fftype import ActiMode, PoolType
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.tensor import Tensor

__all__ = ["alexnet", "resnet", "resnext50", "inception_v3"]


def alexnet(model: FFModel, batch: int, num_classes: int = 10,
            height: int = 229, width: int = 229) -> Tensor:
    """``alexnet.cc:70-83``: 5 conv + 3 pool + 3 dense."""
    t = model.create_tensor((batch, 3, height, width), name="image")
    t = model.conv2d(t, 64, 11, 11, 4, 4, 2, 2, ActiMode.RELU)
    t = model.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = model.conv2d(t, 192, 5, 5, 1, 1, 2, 2, ActiMode.RELU)
    t = model.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = model.conv2d(t, 384, 3, 3, 1, 1, 1, 1, ActiMode.RELU)
    t = model.conv2d(t, 256, 3, 3, 1, 1, 1, 1, ActiMode.RELU)
    t = model.conv2d(t, 256, 3, 3, 1, 1, 1, 1, ActiMode.RELU)
    t = model.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = model.flat(t)
    t = model.dense(t, 4096, ActiMode.RELU)
    t = model.dense(t, 4096, ActiMode.RELU)
    t = model.dense(t, num_classes)
    return model.softmax(t)


def _bottleneck(model: FFModel, t: Tensor, out_channels: int, stride: int) -> Tensor:
    """``resnet.cc:36-59`` BottleneckBlock: 1x1 -> 3x3(stride) -> 1x1(4x),
    projection shortcut when shape changes, relu after the residual add."""
    inp = t
    t = model.conv2d(t, out_channels, 1, 1, 1, 1, 0, 0, ActiMode.NONE)
    t = model.conv2d(t, out_channels, 3, 3, stride, stride, 1, 1, ActiMode.NONE)
    t = model.conv2d(t, 4 * out_channels, 1, 1, 1, 1, 0, 0)
    if stride > 1 or inp.shape[1] != 4 * out_channels:
        inp = model.conv2d(inp, 4 * out_channels, 1, 1, stride, stride, 0, 0,
                           ActiMode.RELU)
    t = model.add(inp, t)
    return model.relu(t)


def resnet(model: FFModel, batch: int, num_classes: int = 10,
           layers=(3, 4, 6, 3), height: int = 229, width: int = 229) -> Tensor:
    """``resnet.cc:85-112`` (ResNet-50 with default ``layers``)."""
    t = model.create_tensor((batch, 3, height, width), name="image")
    t = model.conv2d(t, 64, 7, 7, 2, 2, 3, 3)
    t = model.pool2d(t, 3, 3, 2, 2, 1, 1)
    out_channels = 64
    for stage, n in enumerate(layers):
        for i in range(n):
            stride = 2 if (stage > 0 and i == 0) else 1
            t = _bottleneck(model, t, out_channels, stride)
        out_channels *= 2
    t = model.pool2d(t, t.shape[2], t.shape[3], 1, 1, 0, 0, PoolType.AVG)
    t = model.flat(t)
    t = model.dense(t, num_classes)
    return model.softmax(t)


def _resnext_block(model: FFModel, t: Tensor, out_channels: int,
                   stride: int, groups: int = 32) -> Tensor:
    """``resnext.cc:14-31``: grouped 3x3 in the bottleneck."""
    inp = t
    t = model.conv2d(t, out_channels, 1, 1, 1, 1, 0, 0, ActiMode.RELU)
    t = model.conv2d(t, out_channels, 3, 3, stride, stride, 1, 1,
                     ActiMode.RELU, groups=groups)
    t = model.conv2d(t, 2 * out_channels, 1, 1, 1, 1, 0, 0, ActiMode.NONE)
    if stride > 1 or inp.shape[1] != 2 * out_channels:
        inp = model.conv2d(inp, 2 * out_channels, 1, 1, stride, stride, 0, 0,
                           ActiMode.RELU)
    return model.relu(model.add(inp, t))


def resnext50(model: FFModel, batch: int, num_classes: int = 1000,
              height: int = 224, width: int = 224) -> Tensor:
    """``resnext.cc:50-86``: ResNeXt-50 32x4d."""
    t = model.create_tensor((batch, 3, height, width), name="image")
    t = model.conv2d(t, 64, 7, 7, 2, 2, 3, 3, ActiMode.RELU)
    t = model.pool2d(t, 3, 3, 2, 2, 1, 1, PoolType.MAX)
    for stage, (width_c, n) in enumerate(((128, 3), (256, 4), (512, 6), (1024, 3))):
        for i in range(n):
            stride = 2 if (stage > 0 and i == 0) else 1
            t = _resnext_block(model, t, width_c, stride)
    t = model.relu(t)
    t = model.pool2d(t, t.shape[2], t.shape[3], 1, 1, 0, 0, PoolType.AVG)
    t = model.flat(t)
    t = model.dense(t, num_classes)
    return model.softmax(t)


# --- InceptionV3 (inception.cc:26-142) ------------------------------------

def _conv(model, t, ch, kh, kw, sh, sw, ph, pw):
    return model.conv2d(t, ch, kh, kw, sh, sw, ph, pw, ActiMode.RELU)


def _inception_a(model: FFModel, t: Tensor, pool_features: int) -> Tensor:
    t1 = _conv(model, t, 64, 1, 1, 1, 1, 0, 0)
    t2 = _conv(model, t, 48, 1, 1, 1, 1, 0, 0)
    t2 = _conv(model, t2, 64, 5, 5, 1, 1, 2, 2)
    t3 = _conv(model, t, 64, 1, 1, 1, 1, 0, 0)
    t3 = _conv(model, t3, 96, 3, 3, 1, 1, 1, 1)
    t3 = _conv(model, t3, 96, 3, 3, 1, 1, 1, 1)
    t4 = model.pool2d(t, 3, 3, 1, 1, 1, 1, PoolType.AVG)
    t4 = _conv(model, t4, pool_features, 1, 1, 1, 1, 0, 0)
    return model.concat([t1, t2, t3, t4], axis=1)


def _inception_b(model: FFModel, t: Tensor) -> Tensor:
    t1 = _conv(model, t, 384, 3, 3, 2, 2, 0, 0)
    t2 = _conv(model, t, 64, 1, 1, 1, 1, 0, 0)
    t2 = _conv(model, t2, 96, 3, 3, 1, 1, 1, 1)
    t2 = _conv(model, t2, 96, 3, 3, 2, 2, 0, 0)
    t3 = model.pool2d(t, 3, 3, 2, 2, 0, 0)
    return model.concat([t1, t2, t3], axis=1)


def _inception_c(model: FFModel, t: Tensor, channels: int) -> Tensor:
    t1 = _conv(model, t, 192, 1, 1, 1, 1, 0, 0)
    t2 = _conv(model, t, channels, 1, 1, 1, 1, 0, 0)
    t2 = _conv(model, t2, channels, 1, 7, 1, 1, 0, 3)
    t2 = _conv(model, t2, 192, 7, 1, 1, 1, 3, 0)
    t3 = _conv(model, t, channels, 1, 1, 1, 1, 0, 0)
    t3 = _conv(model, t3, channels, 7, 1, 1, 1, 3, 0)
    t3 = _conv(model, t3, channels, 1, 7, 1, 1, 0, 3)
    t3 = _conv(model, t3, channels, 7, 1, 1, 1, 3, 0)
    t3 = _conv(model, t3, 192, 1, 7, 1, 1, 0, 3)
    t4 = model.pool2d(t, 3, 3, 1, 1, 1, 1, PoolType.AVG)
    t4 = _conv(model, t4, 192, 1, 1, 1, 1, 0, 0)
    return model.concat([t1, t2, t3, t4], axis=1)


def _inception_d(model: FFModel, t: Tensor) -> Tensor:
    t1 = _conv(model, t, 192, 1, 1, 1, 1, 0, 0)
    t1 = _conv(model, t1, 320, 3, 3, 2, 2, 0, 0)
    t2 = _conv(model, t, 192, 1, 1, 1, 1, 0, 0)
    t2 = _conv(model, t2, 192, 1, 7, 1, 1, 0, 3)
    t2 = _conv(model, t2, 192, 7, 1, 1, 1, 3, 0)
    t2 = _conv(model, t2, 192, 3, 3, 2, 2, 0, 0)
    t3 = model.pool2d(t, 3, 3, 2, 2, 0, 0)
    return model.concat([t1, t2, t3], axis=1)


def _inception_e(model: FFModel, t: Tensor) -> Tensor:
    t1 = _conv(model, t, 320, 1, 1, 1, 1, 0, 0)
    t2i = _conv(model, t, 384, 1, 1, 1, 1, 0, 0)
    t2a = _conv(model, t2i, 384, 1, 3, 1, 1, 0, 1)
    t2b = _conv(model, t2i, 384, 3, 1, 1, 1, 1, 0)
    t3i = _conv(model, t, 448, 1, 1, 1, 1, 0, 0)
    t3i = _conv(model, t3i, 384, 3, 3, 1, 1, 1, 1)
    t3a = _conv(model, t3i, 384, 1, 3, 1, 1, 0, 1)
    t3b = _conv(model, t3i, 384, 3, 1, 1, 1, 1, 0)
    t4 = model.pool2d(t, 3, 3, 1, 1, 1, 1, PoolType.AVG)
    t4 = _conv(model, t4, 192, 1, 1, 1, 1, 0, 0)
    return model.concat([t1, t2a, t2b, t3a, t3b, t4], axis=1)


def inception_v3(model: FFModel, batch: int, num_classes: int = 1000,
                 height: int = 299, width: int = 299) -> Tensor:
    """``inception.cc:119-142``."""
    t = model.create_tensor((batch, 3, height, width), name="image")
    t = _conv(model, t, 32, 3, 3, 2, 2, 0, 0)
    t = _conv(model, t, 32, 3, 3, 1, 1, 0, 0)
    t = _conv(model, t, 64, 3, 3, 1, 1, 1, 1)
    t = model.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = _conv(model, t, 80, 1, 1, 1, 1, 0, 0)
    t = _conv(model, t, 192, 3, 3, 1, 1, 0, 0)
    t = model.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = _inception_a(model, t, 32)
    t = _inception_a(model, t, 64)
    t = _inception_a(model, t, 64)
    t = _inception_b(model, t)
    t = _inception_c(model, t, 128)
    t = _inception_c(model, t, 160)
    t = _inception_c(model, t, 160)
    t = _inception_c(model, t, 192)
    t = _inception_d(model, t)
    t = _inception_e(model, t)
    t = _inception_e(model, t)
    t = model.pool2d(t, t.shape[2], t.shape[3], 1, 1, 0, 0, PoolType.AVG)
    t = model.flat(t)
    t = model.dense(t, num_classes)
    return model.softmax(t)
