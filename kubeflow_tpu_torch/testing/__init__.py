"""Test harness of the port: the fault-injection sites and seeded CNN
weights."""
