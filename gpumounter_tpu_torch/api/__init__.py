"""Wire contracts: the kubelet PodResources API (v1alpha1 and v1) and the
kubelet device-plugin API (v1beta1), beside the port's own ``gpu_mount``.

The ``.proto`` files are byte-identical copies of the control plane's,
under the same file names and proto packages, so both packages' generated
modules load side by side into protobuf's default descriptor pool (an
identical file is added once; a renamed file defining the same symbols
would collide). The ``*_pb2.py`` modules are generated; regenerate them
with ``make -C gpumounter_tpu_torch/api``. They need ``protobuf`` and are
imported only where a real socket is spoken (the gRPC clients, the fake
kubelet server and the stub device plugin), never at package import.
"""
