"""Plain references, one module a configuration names, called by the
cell's task as that task needs: for ``partial_hevp``, ``eigenvalues(
problem, k, spec, device)`` gives the ``k`` smallest eigenvalues of the
problem the configuration's maker made, in float64, by NumPy or plain
PyTorch alone.  Nothing here imports the program."""
