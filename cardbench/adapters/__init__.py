"""Adapters to the program under test: how a configuration's model and its
batches are built in the port from the harness's weights and season. One
module a kind of model, found by the name a configuration gives. The
drivers of ``cardbench/drivers/`` call the built model's public entry
points; adapters and drivers are the only modules that import the port."""
