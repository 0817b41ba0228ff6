"""The paper's applications on the port: the Table-III networks as graphs
(``paper_graphs``) and the camera ISP of §V (``camera``)."""
