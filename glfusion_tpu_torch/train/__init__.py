"""Training of the port: losses, metrics, optimizer, steps and the Trainer."""
