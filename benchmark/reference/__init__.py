"""Plain PyTorch references of the configurations, one module each, named by
the configuration file's `reference` key. They import nothing of the port."""
