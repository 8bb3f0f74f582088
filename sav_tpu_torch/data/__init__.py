"""The port's data path: the constants, the augment DSL, the device feeder,
synthetic batches, and the host input path (TFRecord and SavRecord sources,
the pipeline's preprocessing and augmentation, the native loader)."""
