"""Action languages of the benchmark: the seeded draw and the plain reference of
each, one module a language, found by the name a configuration gives."""
