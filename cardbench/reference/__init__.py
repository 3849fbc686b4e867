"""The plain reference that decides ``correct``: K·u element by element in
float64 with plain PyTorch operations (``operator.py``), and the judge of a
displacement field against its load (``judge.py``).

It works from the model's own arrays (connectivity, signs, unit element
matrices, stiffness scales, Dirichlet set) as the frozen generators built
them, and imports nothing of the port: the port's partition, packed data
and kernels are the program's, which the reference does not trust.
"""
