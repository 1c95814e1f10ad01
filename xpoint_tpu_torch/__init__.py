"""XPoint on PyTorch and CUDA (NVIDIA H100): the port of ``xpoint_tpu``.

This package holds the serving path (detect + describe + match, and the
homography by RANSAC on the device), the training step, homographic
adaptation and the label export of the flagship VMamba XPoint, of the
full cycle's CNN models (two spectrum encoders, per-spectrum BatchNorm)
and of the SwinV2 XPoint of ``configs/cmt.yaml`` (with the HomographyNet
head, pretrained encoders under the reference's key names and the sparse
descriptor loss),
the Trainer with its checkpoints, ``model_io`` and config files, the host
data path, and evaluation (the metrics, the metric sweep and timing
harness, and the ``benchmark`` entry point, ``python -m
xpoint_tpu_torch.cli.benchmark``), and their multi-device paths over
``torch.distributed`` (``parallel``: one process a rank; data-parallel
training through the Trainer, sharded serving and HA export, the
sequence-parallel ring scan), with hand-written Hopper kernels for the
TPU kernels on those paths:

  * ``ops.selective_scan_cuda`` / ``csrc/selective_scan_bidir.cu`` replaces
    ``xpoint_tpu/ops/selective_scan_pallas.py::_fused_bidir_kernel``
    (with its checkpoint mode for training);
  * ``ops.selective_scan_cuda`` / ``csrc/selective_scan_bidir_bwd.cu``
    replaces ``_fused_bidir_bwd_kernel``, the scan's backward;
  * ``ops.nms`` / ``csrc/nms_sweep.cu`` replaces
    ``xpoint_tpu/ops/nms.py::_nms_sweep_kernel``;
  * ``ops.warp_projective`` / ``csrc/warp_projective.cu`` replaces
    ``xpoint_tpu/ops/warp_tiled.py::_warp_pallas_kernel``;
  * ``ops.selective_scan_cuda`` / ``csrc/selective_scan_fused.cu`` and
    ``ops.linear_scan`` / ``csrc/linear_scan.cu`` replace
    ``_fused_scan_kernel`` and ``_scan_kernel``.

Ground rules:

  * ``xpoint_tpu/`` (JAX/flax/Pallas) stays exactly as it is: it is the
    reference every module here is held against by the CPU parity tests
    (``tests/test_torch_*.py``).
  * This package imports ``torch`` and never ``jax``, ``flax`` or anything
    under ``xpoint_tpu``, not even its jax-free helpers: it keeps its own
    copies (``utils.dicttools``, ``data.loader``, the flagship model and
    training configs in ``models.xpoint``).
  * Entry points take an explicit ``device``, default ``"cuda"``; the tests
    pass ``device="cpu"``. Randomness comes from an explicit
    ``torch.Generator`` passed in. A kernel wrapper runs its plain PyTorch
    version only for a tensor that lies on the CPU. For a CUDA tensor it
    launches the kernel or raises: there is no fallback when a kernel
    fails to build or launch.
  * Mixed precision is explicit casts, as in the JAX code: parameters are
    fp32, activations are computed in the model dtype, LayerNorm and
    BatchNorm run in fp32, heads emit fp32, the scan carry is fp32. No
    autocast and no loss scaling. Parity runs set ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` to False.
  * Public functions keep the JAX package's NHWC layout.
"""
