"""One module a method: how the benchmark builds the port's trainer for a
configuration, makes its trainable state from the seed, binds the plain
reference, and lists the work of a step (its operations and its kernel
calls).  A configuration names its module under ``method``."""
