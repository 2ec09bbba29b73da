"""Console colours and the loss meters of the trainer."""
