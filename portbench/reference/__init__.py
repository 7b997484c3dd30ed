"""The plain reference that decides `correct`: the network, its training
step and the comparisons, in plain PyTorch and NumPy.

It imports neither JAX nor either package of this repository, and takes
nothing that the program made: it reads the `.rsr` weight files and the
inputs the harness generated, and works out everything else (the
bilinear base, the LR crops, the initial parameters, Adam) itself.
"""
