"""Model zoo: configs, layers and the dense decoder forward."""
