"""Pooling layers — port of ``paddle_tpu/nn/layer/pooling.py``
(``MaxPool1D/2D/3D``, ``AvgPool1D/2D/3D``, ``AdaptiveAvgPool1D/2D/3D``,
``AdaptiveMaxPool1D/2D/3D`` and ``MaxUnPool1D/2D/3D``), each a call of its
functional (``nn/functional/pooling.py``)."""
from __future__ import annotations


from .. import functional as F
from .layers import Layer

__all__ = [
    "MaxPool1D", "MaxPool2D", "MaxPool3D",
    "AvgPool1D", "AvgPool2D", "AvgPool3D",
    "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
    "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
    "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D",
]


class _Pool(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, exclusive=True, data_format=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.return_mask = return_mask
        self.exclusive = exclusive
        self.data_format = data_format


class MaxPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode, return_mask,
                         data_format="NCL")

    def forward(self, x):
        return F.max_pool1d(x, self.kernel_size, self.stride, self.padding,
                            self.return_mask, self.ceil_mode,
                            self.data_format)


class MaxPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode, return_mask,
                         data_format=data_format)

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.return_mask, self.ceil_mode,
                            self.data_format)


class MaxPool3D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCDHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode, return_mask,
                         data_format=data_format)

    def forward(self, x):
        return F.max_pool3d(x, self.kernel_size, self.stride, self.padding,
                            self.return_mask, self.ceil_mode,
                            self.data_format)


class AvgPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode,
                         exclusive=exclusive, data_format="NCL")

    def forward(self, x):
        return F.avg_pool1d(x, self.kernel_size, self.stride, self.padding,
                            self.exclusive, self.ceil_mode, self.data_format)


class AvgPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode,
                         exclusive=exclusive, data_format=data_format)

    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.exclusive, None,
                            self.data_format)


class AvgPool3D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode,
                         exclusive=exclusive, data_format=data_format)

    def forward(self, x):
        return F.avg_pool3d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.exclusive, None,
                            self.data_format)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self._output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self._output_size)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self._output_size = output_size
        self._data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self._output_size, self._data_format)


class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__()
        self._output_size = output_size
        self._data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self._output_size, self._data_format)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self._output_size = output_size
        self._return_mask = return_mask

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self._output_size, self._return_mask)


class AdaptiveMaxPool1D(AdaptiveMaxPool2D):
    def forward(self, x):
        return F.adaptive_max_pool1d(x, self._output_size, self._return_mask)


class AdaptiveMaxPool3D(AdaptiveMaxPool2D):
    def forward(self, x):
        return F.adaptive_max_pool3d(x, self._output_size, self._return_mask)


class _MaxUnPool(Layer):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0, data_format=None,
                 output_size=None, name=None):
        super().__init__()
        self._args = (kernel_size, stride, padding, data_format, output_size)

    def forward(self, x, indices):
        k, s, p, df, osz = self._args
        return getattr(F, self._fn)(x, indices, k, stride=s, padding=p,
                                    data_format=df, output_size=osz)


class MaxUnPool1D(_MaxUnPool):
    _fn = "max_unpool1d"

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, data_format,
                         output_size)


class MaxUnPool2D(_MaxUnPool):
    _fn = "max_unpool2d"

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, data_format,
                         output_size)


class MaxUnPool3D(_MaxUnPool):
    _fn = "max_unpool3d"

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, data_format,
                         output_size)
