"""Visualisation: the affordance products as coloured meshes and images
(``viz.py``), the occupancy volume render (``volume.py``), BEHAVE contact
scenes (``contact_viz.py``) and step videos of the inpainting loop
(``video.py``)."""
