"""repro_torch: Mirage's provisioning decision path in PyTorch, with
hand-written CUDA kernels for the NVIDIA H100.

The package mirrors ``repro``'s layout module by module. The numpy layers
(simulator, environments, state encoder, heuristics) are verbatim copies;
the foundation models, the DQN learner's serving surface and the two
kernels on the serving path (flash attention, grouped GEMM) are ported.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
__version__ = "0.1.0"
