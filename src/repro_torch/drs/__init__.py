"""The resource-management substrate: the cluster datamodel and its array
views, actions, the entitlement waterfills, and the cap-only regime's
placement, balancer and DPM configurations."""
