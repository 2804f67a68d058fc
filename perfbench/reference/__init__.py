"""The benchmark's plain reference: what a hyperplane query over a set of
live rows must answer, in plain PyTorch, from the data the benchmark made.

It imports nothing of the program under test (nor JAX): the seeded
projection generator is a frozen copy (``generator``), and every code,
distance, candidate list and margin is worked out again here.
"""
