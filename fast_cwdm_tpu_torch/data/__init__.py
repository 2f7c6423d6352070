"""NIfTI IO, BraTS preprocessing, datasets and batches (numpy), and the
prefetch to the device."""
