"""The plain reference of the benchmark's configurations.

Plain PyTorch and NumPy, written from the configurations' published
equations and the trainers' documented protocols. It imports nothing of the
program under test and of JAX, and takes nothing the program made: it builds
its own graph, normalisation, hub partition and edge-drop masks from the raw
edge list, and draws its own dropout from the trainers' ``(seed, epoch)``
generator protocol.
"""
