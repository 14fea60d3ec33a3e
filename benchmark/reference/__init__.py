"""The benchmark's plain reference: float32 PyTorch from the architectures'
and the sampler's published descriptions, with its own reading of the flat
parameter vector.  It imports nothing of the program and takes nothing that
the program made."""
