"""Distance, selection and scan ops."""
