"""U-Net and attention modules."""
