"""System services of the training loop: the step governor."""
