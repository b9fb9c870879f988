"""The port's batched crypto data plane (counterpart of ``bftkv_tpu/ops``).

``rns`` holds the residue-number-system engine with its plain PyTorch
versions; ``cuda_rns`` wraps the two hand-written Hopper kernels
(``csrc/rns_chain.cu``), which ``_build`` compiles at first use;
``dispatch`` batches requests from many threads into shared launches.
"""
