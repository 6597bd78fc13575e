"""The benchmark's plain reference: PyTorch and NumPy only, independent of
the program under test (it imports neither ``repro_torch`` nor the JAX
package). Each module re-derives from the seed what the program derives
in its set-up, and recomputes what the timed path produces."""
