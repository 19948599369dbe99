"""The paper's evaluation simulator (``simulator.py``): sampled iteration
times and full training runs of every scheme on the device."""
