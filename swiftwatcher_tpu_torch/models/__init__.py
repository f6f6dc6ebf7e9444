"""The SqueezeNet segment filter (`--classify`): network, preprocessing, filter."""
