"""3-D UNet denoiser with the reference torch parameter layout."""
