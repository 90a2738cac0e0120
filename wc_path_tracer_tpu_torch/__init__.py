"""PyTorch/CUDA port of wc_path_tracer_tpu for one NVIDIA H100.

Mirrors the JAX package's layout (ops/, scene/, models/, render/, kernels/,
parallel/, optim/, io/, utils/, cli.py) so each module's counterpart is easy
to find; the JAX package stays the reference the port is tested against.
Entry points that create tensors take ``device=`` and default to the CUDA
card (utils/device.py).
"""

from wc_path_tracer_tpu_torch.utils.config import RenderConfig  # noqa: F401
