"""The plain reference that decides ``correct``.

Frozen copies, in plain torch and numpy, of the port's plain functions on
the two timed paths (detection and fit, the experiment step, the host
half of the experiment and the z-stack background), and a numpy greedy
linker in place of the port's C++ one. Nothing here imports the port,
JAX or the JAX package, and nothing here takes anything the port has made:
it works every answer out again from the same input stack.
"""
