"""Distributed runtime of the port: the node-stacked trainer and its flat
state layout.  The n nodes are stacked on one device, as the JAX package's
runtime stacks them on its node mesh axis."""
