"""The port's hand-written Hopper kernels, one package each, beside their
plain PyTorch versions.  Every route is differentiable: flash attention
and RMSNorm wrap their forward and backward kernels in a
``torch.autograd.Function``; the overlay executor, like the JAX package's,
has no gradient."""
