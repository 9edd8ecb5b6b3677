"""Value heads of the benchmark: the seeded weight recipe and the plain forward
pass of each head kind, one module a kind, found by the name a configuration
gives."""
