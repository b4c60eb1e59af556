"""The served codec and classifier's share of the chip's float32 peak, in
%: the reference's FLOPs an image (g_a, h_a, h_s, the context model and
entropy parameters at every position once, g_s, ResNet-50 on the 256 px
reconstruction, counted on meta tensors) times the traced window's images
a second, over 67 TFLOP/s (`readers.serve_mfu`)."""
from portbench.readers import serve_mfu as read  # noqa: F401
