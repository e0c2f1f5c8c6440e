"""Graph IR over traced PyTorch modules and its interpreter."""
