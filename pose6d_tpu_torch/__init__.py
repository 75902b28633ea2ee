"""pose6d_tpu_torch: the PyTorch/CUDA port of pose6d_tpu for NVIDIA Hopper.

The JAX package ``pose6d_tpu`` is the frozen reference; this package
imports nothing of it (nor of JAX). Its entry points run on ``cuda``
unless the caller passes ``device="cpu"``: ``api.Predictor.predict``
(the online mode: depth frame -> on-device cloud and spectral operators
-> DPFMNet -> filter -> RANSAC -> ICP -> flip disambiguation),
``api.Predictor.predict_with_operators`` (the cached mode),
``serving.export_predictor`` / ``serving.load_exported`` (the online
frame as one torch.export artifact),
``train.loop.train`` (data-parallel over processes, one per card: see
``parallel``), ``train.eval_loop.evaluate`` (frame-sharded inside a
process group) and the command-line
workflow (``python -m pose6d_tpu_torch.cli.<name>``: gen_shapes,
synth_data, generate_cache, train, eval, pose, ir_extraction). The hot
steps of the main path run in hand-written CUDA C++ kernels
(``csrc/``), built at first use; on CPU tensors each kernel's plain
PyTorch version runs instead.
"""
