"""Step builders (the port of ``repro.train``): the serving steps for now;
the training step follows with the training slice."""
