"""TPUMounter's in-pod validation harness, ported to PyTorch and CUDA.

The control plane (:mod:`gpumounter_tpu`) hot-attaches accelerators to a
running Pod; its in-pod harness, :mod:`gpumounter_tpu.jaxcheck`, proves
after an attach that the devices compute. This package is the same harness
for NVIDIA Hopper GPUs: :mod:`gpumounter_tpu_torch.torchcheck` mirrors
``jaxcheck`` file for file where a file is ported, and every Pallas kernel
on its path is a CUDA kernel written by hand for ``sm_90a``. Below the
harness sits the control plane's node half for NVIDIA GPUs, ported module
by module: the device layer (:mod:`.device`), the kubelet collector
(:mod:`.collector`) and the host actuation (:mod:`.actuation`: device gate,
cgroups, device nodes in the container).

The package imports ``torch`` and ``numpy`` (and ``grpc`` and
``protobuf`` inside the kubelet gRPC client and the fake kubelet alone):
never ``jax`` and nothing of :mod:`gpumounter_tpu`. Its entry points run on the GPU unless the caller
passes ``device="cpu"``; with no GPU present they raise.
"""

__version__ = "0.1.0"
