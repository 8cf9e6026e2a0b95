"""The language-feature autoencoder (port of langsplat4d/ae)."""
