"""Device plane: the field and curve layers in plain PyTorch (field.py,
curve.py), the bitmap and RLC verification planes (verify.py, msm.py)
with their CUDA kernels (csrc/, built by _build.py)."""
