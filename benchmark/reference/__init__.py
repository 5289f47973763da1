"""Plain PyTorch references of the configurations, one module each, named by
the configuration file's `reference` key. They import nothing of the port.
Each declares `TERMS`, the names of the loss terms its steps return, in
order, and has what the drivers call (`adam_steps`, `lbfgs_steps`)."""
