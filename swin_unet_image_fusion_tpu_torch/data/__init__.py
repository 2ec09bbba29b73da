"""The training data: paired IR/visible images, batches and their prefetch to the device."""
