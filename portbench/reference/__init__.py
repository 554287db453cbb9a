"""The benchmark's plain reference of the VAE-HMM: the conv encoder, the
input-conditioned prior, the decoder, the masked negative ELBO, its
gradients, the clipped Adam update, the window gather and a Viterbi
decode, in plain PyTorch.

It imports nothing of the program under test (`vqvaehmm_tpu_torch`) nor
of the JAX package, and takes nothing the program made: it is handed the
weights, the data and the draws the benchmark made, and works out again
whatever the program derives from them (windows, packed weights,
optimizer state).

Every product runs through `vaehmm.product`, which rounds both operands
with the precision function it is given (`precision.py`): float32 with
TF32 off is the reference itself; TF32, bfloat16 or fp8 operands make the
control that a cell's comparison has to fail.
"""
