"""Microbenchmarks on a GPU, one module for each Pallas prototype of the JAX
repository's `experiments/` (same file names), each beside the production
kernel it probes:

    proto_realign     E5  the section realign copy             probes K1
    proto_dma         E1  per-chain fetches, double-buffered   probes K1 and K2
    micro_gather      E3  dependent lookups, four table routes probes K2 and K4
                      E4a one take_along_axis (gather_row)
    proto_round_loop  E4b the tANS round skeleton              probes K2
    pallas_bitonic    E2  a row sorted inside one cluster      probes K8

Each module holds its kernel's wrapper (csrc/*.cu, built by ops/kernels.py),
the plain PyTorch version, and a `main()` that reruns the experiment's own
shapes on the card, prints them in the experiment's units and returns the
kernel's rows (chip_smoke.py's phase 6 drives every `main()`):

    python -m pcodec_tpu_torch.experiments.<module>

The wrappers take the plain version for CPU tensors and launch the kernel
or raise for CUDA tensors; `main()` needs a card.
"""
