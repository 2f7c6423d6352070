"""NIfTI IO and BraTS preprocessing (numpy only)."""
