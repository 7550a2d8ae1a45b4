"""UI layer: property-widget schemas, scene hierarchy panel, web viewer.

Replacement of the reference's ImGui/GLFW editor stack
(src/ui/*, src/graphics/window.*): see widgets.py, scene_panel.py,
server.py.
"""
