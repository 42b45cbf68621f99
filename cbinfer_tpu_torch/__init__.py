"""cbinfer_tpu_torch: the PyTorch + CUDA port of cbinfer_tpu (change-based
video CNN inference) for NVIDIA Hopper.

It stands alone: it imports torch and numpy, never jax and nothing of
cbinfer_tpu. Entry points run on the card unless the caller passes
``device="cpu"``, where every kernel wrapper takes its plain PyTorch
version. Layout:

  config, models      layer-spec IR, the scene, seg and pose model families
  network, checkpoint dense baseline path, weights, mid-video state
  ops/                detect, compact, delta-conv/pool helpers, geometry,
                      the small-cin stem's gate and plain detect (flat4)
  ops/kernels/        the hand-written CUDA kernels' wrappers, plain
                      versions and launch counters; sources in csrc/
  layers, convert     change-based layers and the network converter
  graph, netview      DAG networks (concat, name-keyed state) and their
                      converter; one layer table over both net types
  runner              the streaming frame loop; scan_video_jit and
                      FrameStepper replay it as CUDA graphs on the card
  profiling           torch.profiler trace, stats table
  zoo                 one-call loading of the shipped workloads
  video, metrics      synthetic labelled video, pose targets, mIoU, PCK,
                      FLOP accounting
  train               weight training on the dense path (autograd, Adam)
  benchmark           CB against dense: bench_network, BenchResult
"""

__version__ = "0.1.0"
