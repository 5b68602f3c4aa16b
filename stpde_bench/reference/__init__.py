"""Plain PyTorch reference of MeshfreeFlowNet's encoder, decoder, jet,
PDE residuals, training step and dense decode.

Written from the model's equations for the benchmark's check of
``correct``: it imports torch, numpy and its own modules, nothing of the
program under test and nothing of the JAX package. It takes the weights
and inputs that the benchmark makes from the seed and works out again
everything the program derives from them (batches, lattices, latent
grids, jets, residuals, gradients, optimizer updates).
"""
