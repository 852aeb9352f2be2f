"""How the benchmark builds the program (the PyTorch / CUDA port) for a
configuration: ``programs/<model>.py``, named by the configuration's
``model``, gives ``model(cfg)`` (the port's model on the current default
device) and ``step(cfg, dtype)`` (the port's loss and train step as its
recipe builds them). A new model family is a new file."""
