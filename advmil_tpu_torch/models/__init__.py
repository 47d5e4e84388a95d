"""MIL backbone, GAN nets and their layers (eval mode)."""
