"""Training of the port: data streams, optimizers and the train step."""
