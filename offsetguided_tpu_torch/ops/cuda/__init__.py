"""Hand-written CUDA kernels for Hopper (`sm_90a`) and their wrappers.

Each wrapper launches its kernel for a CUDA tensor and counts the launch in
its `launches` attribute; a CPU tensor takes the plain PyTorch version. A
build or launch failure raises."""
