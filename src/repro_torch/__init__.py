# PyTorch/CUDA port of the repro package, module for module.  Packed codes
# travel as int32 tensors carrying uint32 bits; every entry point takes a
# `device` (default "cuda") and raises when CUDA is asked for but absent.
# Tensors on the CPU take each kernel's plain PyTorch version; tensors on a
# CUDA device launch the hand-written kernels under kernels/csrc/.
