# sparse operators and the Chebyshev preconditioner on torch tensors
