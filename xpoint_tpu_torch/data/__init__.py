"""Device-resident training data and augmentation."""
