"""Plain PyTorch references of the benchmark's entry points. They import
nothing of the program under test and nothing of JAX."""
